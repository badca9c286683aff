#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and nvcc
(``/usr/local/cuda``). It imports nothing of JAX. Phases, each printed:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of ``tpuir_torch/csrc/*.cu`` with nvcc (one process a
   source, all at once), timed.
2. K1 (``fused_transformer_block``) against its plain PyTorch version (TF32
   off) at the five block shapes of Restormer@256, batch 8, in both
   LayerNorm variants, with kernel and plain times from CUDA events; then,
   at each shape, the tensor-core GEMM core that K1's four 1x1 products run
   on (``ops/tc_gemm.gemm_f32x3``, 3xTF32) alone at each product's shape:
   its max error against float64 and its TFLOP/s beside ``torch.matmul``
   in float32 (TF32 off) on the same operands, a yardstick of the GEMM
   step only (the port never calls ``torch.matmul`` for them).
3. The Restormer path: seeded weights for the released color-denoising
   sigma=25 Restormer (full width) are written as a released ``.pth``,
   loaded through ``tpuir_torch.zoo.get_model_instance``, and three
   synthetic requests are served through ``core.engine.run_model_inference``
   with host AWGN and scored with ``calculate_metrics``, three rounds. K1's
   launch count must be 44 per forward chunk, and the kernel path must
   repeat bit for bit. The same requests through the same weights with
   plain blocks (served in turns with the kernel path), and the smallest
   request on the CPU, must agree to 1 uint8 LSB.
4. K6 (``mixer_prologue``), K2 (``nss_scan``, shift off and on, 128x128 at
   batch 8 and the 96x72 tile at batch 1) and K7 (``mixer_epilogue``)
   against their plain versions at MaIR-CDN@128, batch 8, full width, on
   seeded weights and the activations the plain mixer makes, with times
   from CUDA events (plain, kernel, kernel, plain); and the GEMM core at
   K6's in_proj and K7's out_proj shapes beside ``torch.matmul``, as in
   phase 2.
5. The MaIR path: seeded weights for the released sigma=25 MaIR-CDN (full
   width and depth) are written as ``MaIR/denoising/MaIR_CDN_s25.pth`` and
   loaded through the zoo; a 256x256 request (9 tiles, chunks 8+1), a
   200x150 request (4 tiles) and a 96x72 request (one rectangular tile) are
   served with host AWGN and scored, three rounds. Each of K6, K2 and K7
   must launch 36 times per forward chunk, and the kernel path must repeat
   bit for bit; one round with plain mixers, and the 96x72 request on the
   CPU, must agree with it to 1 uint8 LSB.

6. K6, K2 and K7 at the five level shapes of MaIRUNet's 384x384 tile at
   batch 8 (d_state 4, 8, 8, 16 and 32), K2 at the rectangular 384x328
   tile of a 481x321 request (batch 2), and K3
   (``selective_scan_fused_proj``) at that request's two K3 levels, 96x82
   and 48x41 (batch 2, d_state 16 and 32), against their plain versions on
   seeded MaIRUNet weights; K2 and K3 must repeat bit for bit. Kernel times
   from CUDA events, the plain version timed once a shape, K3's beside its
   MUFU floor (one exp2 a state update); the GEMM core at
   K6's in_proj and K7's out_proj shapes of each level beside
   ``torch.matmul``, as in phase 2.
7. The MaIRUNet path: seeded weights for the released real-denoising
   MaIRUNet (full width and depth) are written as
   ``MaIR/denoising/MaIR_RealDN.pth`` and loaded through the zoo; noisy
   inputs made on the host from a seed are served as they are
   (``need_degradation=False``): a 720x1280 frame (15 tiles, chunks 8+7,
   every level on K2) on the kernel path only, and 256x256 (one tile),
   481x321 (two 384x328 tiles, K3 at 96x82 and 48x41) and 120x90 (one tile
   padded to 120x96, K3 at 30x24 and 15x12) on both paths, three kernel
   rounds. Launches per chunk follow each level's route (44 each of K6, K2,
   K7 where every level is on K2; 24 of those and 20 of K3 otherwise); the
   kernel path must repeat bit for bit and agree with the plain path, and
   with the CPU on 120x90, to 1 uint8 LSB.
8. K5 (``nss_scan_fused``) against its plain version (the id table against
   the kernel's stripe arithmetic): MaIR-CDN@128 at batch 8 with the shift
   off and on (timed plain, kernel, kernel, plain), the 96x72 tile at batch
   1 (y23 72x96), MaIRUNet's five level shapes of a 384x384 tile at batch 8
   and the 384x328 tile at batch 2; it must repeat bit for bit.
9. The fused route: MaIR-CDN and MaIRUNet built through the zoo with
   ``nss="fused"`` on the seeded weights of phases 5 and 7. MaIR-CDN serves
   phase 5's three requests, three rounds: 36 K5 launches a chunk and none
   of K6, K2 or K7, repeatable, within 1 uint8 LSB of phase 5's stripe-route
   outputs, and on 96x72 of the fused route's plain path and of the CPU;
   engine Mpix/s beside the stripe route's. MaIRUNet serves the 481x321
   request, three rounds: 24 K5 and 20 K3 launches a chunk, within 1 LSB of
   phase 7's output.
10. K4 (``selective_scan_kernel``): its entry point at MaIR-CDN's shape
    (B 8, K 4, L 16,384, D 234, N 16), at MaIRUNet's latent (B 8, K 4,
    L 2,304, D 768, N 32) and at a ragged case with K 2 and no D or delta
    bias, then each output against ``selective_scan``, repeated bit for bit.
11. P1 (``utils/micro_rate.probe``) against ``probe_plain`` at the JAX
    probe's shapes (x (8, 512, 128), 32 rounds) for mul, fma and exp2,
    within rtol 1e-5 and bit for bit on repeat; then the rate entry point
    (the three elementwise rates), the float32 (TF32 off), TF32 and bf16
    ``torch.matmul`` rates at 8192^3, and the scan floor at MaIR-CDN@128
    and the MUFU floors (two exp2 a state update for the three-pass scan of
    K2, K5 and K4, one for K3's one-pass scan) from the measured rates,
    beside K2's, K5's, K4's and K3's times of phases 4, 8, 10 and 6.
12. Restormer's serving precision. The GEMM core's bf16-operand kernel
    alone at K1 serving's apply, projection and project_out shapes (against
    float64 products of its operands, beside ``torch.matmul`` in bf16); K1's
    serving body at the five Restormer@256 block shapes, batch 8, both
    LayerNorm variants, held stage by stage against functions of its own
    previous stage (``utils/serving_check.py``), bit for bit on repeat, timed
    beside its plain version and beside the recorded times of the unfused
    body it replaced (``K1_SERVING_REPLACED_MS``); its mutation controls (``python -m
    tpuir_torch.utils.serving_mutants --bodies K1``: 16 required faults);
    then the released sigma=25 Restormer built through the
    zoo with ``precision="serving"`` on phase 3's weights serves phase 3's
    requests, three rounds: 44 serving-body launches a chunk and no parity
    K1 launch, repeatable, within 2 uint8 LSB of the same path with plain
    serving blocks, PSNR within 0.05 dB of phase 3's parity outputs.
13. MaIR-CDN's serving precision. The GEMM core's bf16-operand kernel
    alone at K7's out_proj shape (beside ``torch.matmul`` in bf16), and
    ``torch.matmul`` bf16 alone at K6's in_proj shape (K6 serving takes
    in_proj fused with its depthwise conv); the serving bodies of K6, K2
    (shift off and on) and K7 at MaIR-CDN@128, batch 8, and at the 96x72
    tile, batch 1, on phase 4's seeded activations (bf16 where the body
    takes bf16), each held stage by stage against float64 functions of its
    own previous stage (``utils/serving_check.py``: K6's and K7's bf16
    weight copies, K6's in_proj halves and x, K2's x_dbl, y and pooled,
    K7's bf16 gated rows and out_proj), bit for bit on repeat, timed beside
    its plain version and beside the recorded times of the bodies they
    replaced (``SERVING_REPLACED_MS``); the mutation controls for the three bodies
    (``utils/serving_mutants.py --bodies mixer``: each fault in its own
    copy, built there; the check must reject the required ones and accept
    the unmutated copy, and prints its verdict on the reported ones); then
    the released sigma=25 MaIR-CDN built through the zoo with
    ``precision="serving"`` on phase 5's weights serves phase 5's requests,
    three rounds: 36 launches a chunk of each serving body and none of the
    parity K6, K2 or K7, repeatable, within 2 uint8 LSB of the same path
    with plain serving mixers, PSNR within 0.05 dB of phase 5's parity
    outputs.
14. MaIRUNet's serving precision and MaIR serving off the stripe route.
    The serving bodies of K6, K2 and K7 at MaIRUNet's five level shapes of
    a 384x384 tile (batch 8) and K2's at the 384x328 tile (batch 2), K3's
    (``selective_scan_fused_proj`` with ``serving=True``) at the 481x321
    request's 96x82 and 48x41 levels (batch 2), and K5's
    (``nss_scan_fused`` with ``serving=True``) at MaIR-CDN@128 (batch 8,
    shift off and on), the 96x72 tile and the 384x328 tile (batch 2), on
    phase 6's and phase 8's seeded weights and activations (bf16 where a
    body takes bf16): each held stage by stage (``utils/serving_check.py``:
    K3's x_dbl and float32 y, K5's x_dbl, bf16 y01 and y23 and pooled), bit
    for bit on repeat, timed beside its plain version (K6, K2 and K7 also beside
    the recorded times of the bodies they replaced, by level and per
    MaIRUNet@384 forward; K5 at MaIR-CDN@128 and 384x328 beside its
    replaced body's, ``K5S_REPLACED_MS``); their mutation
    controls (``utils/serving_mutants.py --bodies seq``); then, through the
    zoo with ``precision="serving"`` on the seeded weights of phases 5 and
    7, three rounds each: MaIRUNet on phase 7's 256x256, 481x321 and 120x90
    inputs (44 launches a chunk each of the K6, K2 and K7 serving bodies
    where every level is on K2; 24 of those and 20 of K3's otherwise; none
    of a parity body), MaIR-CDN with ``nss="fused"`` on phase 5's requests
    (36 K5 serving launches a chunk), MaIRUNet with ``nss="fused"`` on
    481x321 (24 K5 and 20 K3 serving launches a chunk) and MaIR-CDN with
    ``nss="0"`` on 96x72 (36 K3 serving launches a chunk): each repeatable,
    within 2 uint8 LSB of the same path with plain serving mixers, PSNR
    within 0.05 dB of the parity outputs of phase 5 or 7, engine Mpix/s
    beside parity's.
15. K2's bf16-recurrence serving body (``nss_scan`` with ``serving=True,
    recur_bf16=True``) at MaIR-CDN@128, batch 8 (shift off and on, timed
    beside its plain version) and at the 96x72 tile, batch 1 (shift on), on
    phase 4's seeded activations rounded to bf16: held stage by stage
    (``utils/serving_check.check_nss_scan_recur_serving``: x_dbl against
    float64, the level-2 carries bit for bit against their emulation from
    the kernel's own x_dbl, y and pooled against float64 sums), bit for bit
    on repeat; its mutation controls (``utils/serving_mutants.py --bodies
    recur``: 5 required faults); then the seeded sigma=15 MaIR-CDN (phase
    5's weights) on phase 5's 200x150 and 96x72 requests and the seeded
    real-denoising MaIRUNet (phase 7's) on its 256x256 and 120x90 inputs,
    each built through the zoo in parity, in serving and in serving with
    ``recur_bf16=True``: the recur path three rounds (36 launches a chunk
    of the recur body and none of ``nss_scan_serving``; MaIRUNet: one a
    stripe-route level's block, K3's serving body elsewhere), repeatable,
    within 2 uint8 LSB of the same path with plain mixers
    (``nss_scan_recur_plain``), PSNR within 0.25 dB of parity (the mode is
    opt-in and not held to serving's 0.05 dB: ``RECUR_PSNR_DB``); each request
    prints PSNR(recur) - PSNR(serving), PSNR(recur) - PSNR(parity), the LSB
    to the plain recur path and engine Mpix/s beside serving's.
16. The evaluation harness on the card: seeded ``{'params': sd}``
    checkpoints of the sigma=15 color Restormer and MaIR-CDN and two
    synthetic CBSD68 images in a temporary tree;
    ``tpuir_torch.harness.Harness(device="cuda")`` runs
    ``gaussian_color_nonblind`` for both models in parity, in serving and
    in serving with ``recur_bf16``, and ``save_results`` writes each run's
    ``results_summary.csv``, whose columns must be tpuir's. Each run's
    launches are counted (K1 or its serving body 44 a chunk; K6, K2 and K7,
    their serving bodies, or the recur body in K2's place, 36 a chunk);
    every row's PSNR must lie within 0.01 dB and its SSIM within 1e-3 of
    the same run with the models' plain twins, the text columns equal.
17. The plain-conv families, which carry no hand kernel (cuDNN convs and
    plain PyTorch): seeded checkpoints in the released formats in a
    temporary tree (DnCNN's ``dncnn_25.pth`` and ``dncnn_color_blind.pth``,
    REDNet's ``50.pt`` and the same weights as a ``50.caffemodel``,
    DeblurGANv2's ``fpn_mobilenet.h5`` and ``fpn_inception.h5``), each
    built through the zoo at full width and depth in parity and in serving
    and served through the engine: DnCNN gray sigma=25 and color blind and
    REDNet sigma=50 (from the ``.pt``, then from the ``.caffemodel``) on a
    BSD68-sized 481x321 request with host AWGN, DeblurGANv2 MobileNet and
    Inception on a GoPro-sized 720x1280 frame blurred by a 9-pixel
    horizontal box, scored against the sharp frame. Each path serves
    ``PLAIN_ROUNDS`` rounds with the kernels' counts set to 0 and must
    launch no hand kernel and repeat bit for bit; parity must agree with
    the port's CPU path within 1 uint8 LSB and serving's PSNR with
    parity's within 0.05 dB; one patch at the model's patch size alone and
    the same patch in a batch of 8 must agree within ``PLAIN_BATCH_TOL``
    (DeblurGANv2's per-sample norms); the ``.caffemodel`` must serve the
    ``.pt``'s output bit for bit. Engine Mpix/s is printed for parity and
    serving.
18. The engine's in-flight window, its host split, and the user entry
    points. Every phase above serves through the window (``max_in_flight``
    4, the default). (a) Restormer sigma=25 on phase 3's 512x512 request,
    MaIR-CDN sigma=25 on phase 5's 256x256 and REDNet sigma=50 on phase
    17's 481x321, each in parity and serving, and MaIRUNet on phase 7's
    720x1280 frame (parity), built through the zoo from seeded checkpoints,
    and Restormer and REDNet serving again at engine batch 2 (5 and 10
    chunks: every staging buffer refilled, the window full), are served
    with ``max_in_flight`` 1, 2 and 4 in turns, three rounds: the outputs
    must be bit-equal across windows and rounds and each serve's launches
    the same, a chunk's as its path's; engine Mpix/s for each window.
    (b) Each batch-8 request of (a), DnCNN gray sigma=25 on 481x321 and
    DeblurGANv2 MobileNet and Inception on 720x1280 in parity and serving,
    split by ``utils.profiling.engine_split`` (host ms by step, median of 3)
    and ``profiled_requests`` (the card's copy and kernel ms, busy ms and
    idle share over two requests). (c) ``demo_core.run_restoration`` on
    ``cuda:0`` with the seeded sigma=25 color Restormer and MaIR-CDN, on a
    200x150 image with AWGN: its output must equal ``run_model_inference``
    on the same model and noisy input bit for bit, with K1's and K6's,
    K2's and K7's launches counted. (d) ``scripts.test_demo``'s gaussian
    color non-blind suite on a temporary demo directory (both PNGs written,
    PSNR finite), ``scripts.test_patch_size`` for DnCNN gray (its trials
    and result) and ``scripts.validate_serving`` for DnCNN and Restormer on
    one synthetic image (its JSON written to a temporary path, serving
    within 0.05 dB of parity).
19. Training (``tpuir_torch/train/``). (a) MaIR-CDN at full width and
    depth (``network_g`` of ``options/test/test_MaIR_CDN_s25.yml``, the
    ``train`` section of ``options/train/GaussianColorDenoising_RestormerSigma25.yml``:
    AdamW 3e-4, weight decay 1e-4, L1, the gradient clip, the cyclic cosine
    schedule, mixup), seeded weights, Gaussian denoising at sigma 25 on
    seeded PNGs, crop 64 and batch 4 (cut from the file's first stage, 128
    and 8, for the phase's time), through ``train_pipeline`` on ``cuda:0``
    for 3 iterations, a save and a validation, then an ``auto_resume`` to
    5: each step's forward launches K6, K2 and K7 36 times each and its
    backward none (each step's forward, backward and optimizer ms from CUDA
    events, its peak memory); the same batches again with the Functions'
    plain forwards (``kernel_grad.plain_forwards``, the twin), each step
    from the kernel run's weights and its optimizer fed the kernel run's
    gradients: the losses within 1e-5 relative, step 1's gradients within
    1e-3 relative L2 a tensor, the weights after each step bit for bit.
    (b) Each differentiable wrapper alone at a MaIR-CDN mixer's width
    (K6, K2, K7, K5 at 64x64, K3 at 66x60, batch 2): its forward outputs
    against the plain version's at the kernel's tolerance, its gradient of
    a seeded cotangent against the plain version's autograd (bit for bit
    by construction: the backward reads only the inputs), one launch in the
    forward and none in the backward. (c) The Restormer sigma=25 option
    file as it is (``parse_options``, ``--force_yml`` to synthetic
    dataroots and 3 iterations) at its first progressive stage, patch 128
    and batch 8, full width, built plain (no K1 launch), its ``net_g_3.pth``
    served by the zoo within 1 LSB of the trained network, then resumed to
    iteration 5.
20. DeblurGANv2 training (``models/deblurgan/``, ``train/deblurgan_*.py``,
    ``train/vgg_features.py``, ``train/fid_inception.py``,
    ``train/extra_metrics.py``), float32 with TF32 off, seeded weights and
    seeded sharp/blurred pairs (a synthetic image and its box blur through
    ``deblurgan_aug``'s geometric transforms, a 256x256 random crop and the
    [-1, 1] normalize). No hand kernel is on this path; none may launch.
    (a) The released recipe: FPN-Inception at the zoo's width, double_gan
    (3-layer PatchGAN and the 5-layer one, instance norm), WGAN-GP with one
    alpha a step from a seeded ``torch.Generator``, the perceptual loss on a
    seeded VGG19 trunk, adv_lambda 0.001, Adam 1e-4 for G and for the Ds,
    batch 1, 5 steps: D on the detached fake, 0.5 (patch + full), then G on
    content + adv_lambda 0.5 (patch + full) against the updated Ds; each
    step's losses finite; per step from CUDA events G's forward, the D step
    split into forward, penalty, backward (the double backward) and
    optimizer, the G step, and the peak memory, with the median over steps
    2-5. Step 1 against the CPU from the same weights, pair and alpha: G's
    output within 1e-4, both losses within 1e-4 relative; and step 1 again
    in float64 on the card and on the CPU, every gradient of G and of both
    Ds within 1e-3 relative L2 a tensor (a tensor that is zero by
    construction, rounding noise on both sides), the card's float32
    gradients printed against the float64 ones. (b) FPN-MobileNet,
    patch_gan, ragan-ls, L1 content, 3 steps: each step's losses and pool
    means within 1e-4 relative of the CPU's started from the card's weights
    and pools, and the pools' ``random.sample`` draws the CPU's under one
    seed. (c) ResnetGenerator (ngf 64, 6 blocks), FPN-Inception-Simple,
    FPN-Dense and UNet-SEResNeXt at full width, 256x256, batch 1, one L1
    forward and backward each, timed: the output within 1e-4 of the CPU's,
    the gradients in float64 on both within 1e-3 relative L2 a tensor,
    whether float32 repeats bit for bit. (d) One D step of the multi-scale
    discriminator with ``train/losses.multi_scale_gan_loss`` (lsgan)
    against the CPU: the float32 loss, the gradients in float64. (e) FID Inception features of 4 seeded 299x299 images
    from a seeded checkpoint read back, on the card and the CPU (within
    1e-4), the FID of the two sets (below 1e-3; computed on the host beside
    the deferred mutation controls), and DeblurGANv2's SSIM on the card
    against the CPU.
21. Data parallelism (``tpuir_torch/parallel/``) on the one card. Phase
    18's Restormer 512x512 and MaIR-CDN 256x256 sigma=25 requests on its
    seeded checkpoints, in parity and in serving, whose batch-8 outputs and
    ms at ``max_in_flight`` 4 are the single-device reference, are served
    through ``parallel.inference.run_model_inference_sharded`` (a) in a
    world of one on NCCL, in this process, and (b) in a world of two on
    gloo, two processes spawned by ``parallel.launch`` on the one card
    (NCCL refuses two ranks on one GPU; the world starts beside (a) and
    (c)'s single-process steps and waits for them), each rank building its
    models with ``zoo.get_model_instance``, three rounds each. The world
    of one must be bit-equal to the engine; the world of two within 1 LSB,
    both ranks returning the same image. Each rank's launches must be 44 of K1 (or
    its serving body) and 36 of K6, K2, K7 (or their serving bodies) a
    forward chunk of its share; the ranks' counts come back with their
    results and count in the kernels line. The gather of the Restormer
    request's predictions is timed both ways (``"host"``: gloo on CPU
    tensors; ``"device"``: the default group on CUDA tensors, NCCL in the
    world of one). (c) MaIR-CDN at full width cut to one residual group of
    six layers (``DDP_DEPTHS``; phase 19 keeps the full depth), phase
    19's ``train`` section with mixup off, crop 64, global batch 4, two
    steps through ``SRModel.optimize_parameters`` under
    DistributedDataParallel in both worlds (each rank its contiguous
    half), against the single-process steps on the full batch: each step's
    loss within 1e-5 relative, step 1's gradients within 1e-3 relative L2
    a tensor (phase 19's bounds), the two ranks' weights equal after each
    step, 6 launches each of K6, K2 and K7 a step's forward; each step's ms.

The serving checks' planted copies (phases 12-15) are built by
``serving_mutants.Prebuilt`` in ``MUTANT_BUILD_JOBS`` background builds
at nice 19, from the end of the build on, so that they overlap phases
2-11, where torch keeps ``MUTANT_BUILD_THREADS`` CPU threads. K1's
mutation controls run in phase 12; those of the MaIR serving bodies
(phases 13-15: ``DEFERRED_MUTANTS``) after phase 20, when their copies
are built, while the FID of phase 20 (e) is computed beside them.

Each path's launch counts are set to 0 just before it is served (K4's and
P1's entry points: just before they are called) and read just after; a
kernel's launches in the JSON line are the sum over the paths it runs on.
The second-to-last line is the kernels' JSON summary: per kernel its
launches, max|kernel - plain| over every check (P1: relative), kernel and
plain ms (K1: per Restormer@256 forward; K6, K2, K7, K5: per call at
MaIR-CDN@128, batch 8; K3: per forward chunk of the 481x321 request, its 12
calls at 96x82 and 8 at 48x41; K4: per call at MaIR-CDN's shape; P1: per
call at the JAX shapes, the mean over the three ops; K1 serving: per
Restormer@256 forward), the least time the card could take for the same
work (``bound_ms``: the largest of its bytes over 3.35 TB/s, its float32
operations over 67 TFLOP/s, an exponential counted as one, and, for the
scans K2, K3, K4 and K5, their exponentials, one a state update, at the
special-function lanes' 4.19 T/s, an eighth of the float32 lanes' 33.5 T
instructions/s; the H100 SXM's data-sheet rates, computed from this run's
shapes; P1, a rate probe: its mul and fma at 33.5 T instructions/s, its
exp2 at an eighth of that) and which bounds it ("operations" for either
rate of operations). K1, K6 and K7, whose products run on the tensor cores
in 3xTF32, also carry ``bound_tc_ms``: their 1x1
products' operations at the TF32 rate over 3 (494.7 / 3 TFLOP/s) plus the
rest at 67 TFLOP/s, or the bytes over 3.35 TB/s where that is larger. K1
serving's ``bound_ms`` is the larger of its bytes (bf16 block IO, float32
weights) over 3.35 TB/s and its products (the Gram and the attention
apply at one head's width) at the dense bf16 rate, 989 TFLOP/s, plus the
rest at 67 TFLOP/s. The MaIR mixer's serving bodies (K6, K2, K7 serving:
per call at MaIR-CDN@128, batch 8; K2 the mean over both shifts) take the
same ``bound_ms``: bf16 where the body moves bf16, their products at the
bf16 rate, and for K2 also its exponentials, one a state update, at the
special-function lanes' rate; so do K3 serving (per forward chunk of the
481x321 request, as K3) and K5 serving (per call at MaIR-CDN@128, batch 8,
the mean over both shifts); so does K2's recur body (per call at
MaIR-CDN@128, batch 8, the mean over both shifts: the serving body's work).
The last line is ``{"ok": true, "device":
{...}}``. Any failed phase raises,
exits non-zero and prints no last line; so does a machine without a CUDA
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
BATCH = 8
ATOL, RTOL = 5e-5, 1e-4  # float32 sums in another order than cuBLAS/cuDNN
SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3  # the scan's own (tests/test_torch_nss.py)
# Restormer@256 block shapes (H = W, C, heads) and how many of the 44 blocks
# of one forward run at each.
BLOCK_SHAPES = [
    ("level1", 256, 48, 1, 4),
    ("level2", 128, 96, 2, 12),
    ("level3", 64, 192, 4, 12),
    ("latent", 32, 384, 8, 8),
    ("decoder1+refinement", 256, 96, 1, 8),
]
REQUESTS = [(512, 512), (481, 321), (200, 150)]  # H x W x 3 uint8
MAIR_REQUESTS = [(256, 256), (200, 150), (96, 72)]
MAIR_TILE = 128  # MaIR-CDN's patch: the kernels' shapes on its path
MAIR_BLOCKS = 36
# MaIRUNet@384 at batch 8: (label, tile side, the stage whose block 0 gives
# the mixer's weights, that width's blocks a forward)
UNET_LEVELS = [
    ("encoder1", 384, "encoder_level1", 4),
    ("decoder1+refinement", 384, "decoder_level1", 8),
    ("level2", 192, "encoder_level2", 12),
    ("level3", 96, "encoder_level3", 12),
    ("latent", 48, "latent", 8),
]
# the 481x321 request's two 384x328 tiles: K2a's case, and K3's two levels
UNET_RECT = (384, 328, "encoder_level1")
UNET_K3_LEVELS = [("level3", 96, 82, "encoder_level3", 12), ("latent", 48, 41, "latent", 8)]
UNET_KERNEL_ONLY = [(720, 1280)]  # a GoPro frame
UNET_REQUESTS = [(256, 256), (481, 321), (120, 90)]
UNET_NOISE = 15.0  # sigma of the host noise on the real-denoising inputs
UNET_FUSED_REQUEST = (481, 321)  # MaIRUNet on the fused route: K5 at 384x328, 192x164
# K4 at (label, B, K, L, D, N, with D and delta_bias)
K4_CASES = [("MaIR-CDN@128", 8, 4, 128 * 128, 234, 16, True),
            ("MaIRUNet latent@384", 8, 4, 48 * 48, 768, 32, True),
            ("ragged", 3, 2, 777, 100, 9, False)]
PROBE_RTOL = 1e-5
# the stages of MaIRUNet and their pyramid level
UNET_STAGES = [("encoder_level1", 0), ("encoder_level2", 1), ("encoder_level3", 2),
               ("latent", 3), ("decoder_level3", 2), ("decoder_level2", 1),
               ("decoder_level1", 0), ("refinement", 0)]
ROUNDS = 3
SIGMA = 25
CONFIG = dict(layer_norm_bias=False)  # the color-denoising Restormer (BiasFree)
ITERS = 10  # launches a CUDA-event timing averages over
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# background builds of the serving checks' planted copies beside phases
# 2-11, and torch's CPU threads meanwhile. On the H100 machine's 8 CPUs
# (python mutant_overlap.py, one run), phases 5, 7 and 9 (their card-vs-CPU
# forwards: torch's threads wait for the slowest) took 221.5 s alone at the
# start and 157.5 s alone at the end, 362.2 s beside 4 builds and 8
# threads, 292.4 s beside 3 and 5, 221.5 s beside 2 and 6. The host's own
# spread (40% between the two alone runs) hides what 2 builds beside 6
# threads cost: that cost is unresolved, not shown to be zero.
MUTANT_BUILD_JOBS, MUTANT_BUILD_THREADS = 2, 6
# (bodies, copies checked at once) whose mutation controls run after phase
# 20: their copies are built by then (on an H100 host the builds of all four
# sets end about 520 s after the start, phase 13 begins near 350 s)
DEFERRED_MUTANTS = (("mixer", 8), ("seq", 8), ("recur", 6))
FP32_FLOP_PER_S = 67e12
F32X3_FLOP_PER_S = 494.7e12 / 3  # dense TF32 tensor-core rate, three products a float32 one
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core rate
# The recorded times of the serving body this one replaced (float32
# intermediates, the products and depthwise convs in separate launches, the
# Gram on the ALU): ms a block at each BLOCK_SHAPES shape (BiasFree, batch 8)
# and a forward. They are the first of the two readings of that body in
# PERF.md §6, taken by utils/gemm_bench.py --kernels K1s --tree <its checkout>
# in turns with this body on an NVIDIA H100 80GB HBM3 at 700.00 W. A recorded
# figure, not a measurement of this run: printed beside this run's times as
# such, and to be timed again with gemm_bench.py --tree on another card.
K1_SERVING_REPLACED_MS = {"level1": 2.760, "level2": 1.398, "level3": 0.772, "latent": 0.588,
                          "decoder1+refinement": 5.436, "forward": 85.263}
# The same for the MaIR mixer's serving bodies of K6 (in_proj on the core's
# old bf16 mode, then the depthwise conv: two launches, the float32 x half
# through device memory) and K7 (float32 gated rows, out_proj on that mode):
# ms a call at MaIR-CDN@128 and at each UNET_LEVELS shape (batch 8), and
# per MaIRUNet@384 forward, as PERF.md section 6 records them (chip_smoke.py
# phases 13 and 14 on an NVIDIA H100 80GB HBM3 at 700.00 W). Recorded
# figures, printed beside this run's times as such.
K6_SERVING_REPLACED_MS = {"MaIR-CDN@128": 0.531, "encoder1": 1.260,
                          "decoder1+refinement": 2.557, "level2": 0.697, "level3": 0.422,
                          "latent": 0.282, "forward": 41.19}
K7_SERVING_REPLACED_MS = {"MaIR-CDN@128": 0.349, "encoder1": 0.927,
                          "decoder1+refinement": 1.745, "level2": 0.472, "level3": 0.293,
                          "latent": 0.204, "forward": 28.49}
# and of K2's (the chunked passes of csrc/chunk_scan.cuh on bf16 x and y: two
# exponentials a state update, a thread a channel), also at the 384x328 tile
# (batch 2), as PERF.md section 6 records them
K2S_REPLACED_MS = {"MaIR-CDN@128": 2.935, "encoder1": 4.826, "decoder1+refinement": 11.916,
                   "level2": 3.071, "level3": 2.465, "latent": 2.405, "rect": 1.215,
                   "forward": 200.32}
# and of K5's (the same passes along the stripe arithmetic): ms a call at
# MaIR-CDN@128 (batch 8, the mean over both shifts) and at the 384x328 tile
# (batch 2, MaIRUNet's level-1 widths)
K5S_REPLACED_MS = {"MaIR-CDN@128": 2.918, "rect": 1.186}
SERVING_REPLACED_MS = {"K6s": K6_SERVING_REPLACED_MS, "K2s": K2S_REPLACED_MS,
                       "K7s": K7_SERVING_REPLACED_MS, "K5s": K5S_REPLACED_MS}
SERVING_LSB = 2  # serving path against its plain-block twin, in uint8 LSB
SERVING_PSNR_DB = 0.05  # serving against parity, per request (BASELINE.json's contract)
# The bf16 recurrence (recur_bf16) is an opt-in mode that the JAX package keeps
# off every default and never held to that contract: on the card it costs
# MaIRUNet 0.08 dB at 256x256 (PERF.md), so its gate against parity is only a
# bound that a broken body would cross; its correctness gate is its plain twin.
RECUR_PSNR_DB = 0.25
# P1's ops a second: a float32 mul or FMA is one instruction of the 128
# float32 lanes an SM (67 TFLOP/s counts an FMA as two flops), an exp2 one
# of the 16 special-function lanes (the Hopper architecture white paper)
P1_OP_PER_S = {"mul": FP32_FLOP_PER_S / 2, "fma": FP32_FLOP_PER_S / 2,
               "exp2": FP32_FLOP_PER_S / 2 / 8}
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "fused_transformer_block": ("tpuir_torch/csrc/fused_block.cu", "tpuir/ops/fused_block.py:338"),
    "mixer_prologue": ("tpuir_torch/csrc/nss_prologue.cu", "tpuir/ops/nss_prologue.py:121"),
    "nss_scan": ("tpuir_torch/csrc/nss_scan.cu", "tpuir/ops/nss_stripe.py:484"),
    "mixer_epilogue": ("tpuir_torch/csrc/nss_epilogue.cu", "tpuir/ops/nss_epilogue.py:140"),
    "selective_scan_fused_proj": ("tpuir_torch/csrc/scan_fused_proj.cu",
                                  "tpuir/ops/scan_pallas.py:340"),
    "nss_scan_fused": ("tpuir_torch/csrc/nss_fused.cu", "tpuir/ops/nss_fused.py:247"),
    "selective_scan": ("tpuir_torch/csrc/selective_scan.cu", "tpuir/ops/scan_pallas.py:117"),
    "rate_probe": ("tpuir_torch/csrc/rate_probe.cu", "benchmarks/micro_vpu.py:60"),
    # the same TPU kernels' serving bodies (K1: mm_bf16, fast_gelu; the others: serving=True)
    "fused_transformer_block_serving": ("tpuir_torch/csrc/fused_block.cu",
                                        "tpuir/ops/fused_block.py:338"),
    "mixer_prologue_serving": ("tpuir_torch/csrc/nss_prologue.cu",
                               "tpuir/ops/nss_prologue.py:121"),
    "nss_scan_serving": ("tpuir_torch/csrc/nss_scan.cu", "tpuir/ops/nss_stripe.py:484"),
    "mixer_epilogue_serving": ("tpuir_torch/csrc/nss_epilogue.cu",
                               "tpuir/ops/nss_epilogue.py:140"),
    "selective_scan_fused_proj_serving": ("tpuir_torch/csrc/scan_fused_proj.cu",
                                          "tpuir/ops/scan_pallas.py:340"),
    "nss_scan_fused_serving": ("tpuir_torch/csrc/nss_fused.cu", "tpuir/ops/nss_fused.py:247"),
    # K2's serving body with the bf16 level-1 recurrence (recur_bf16=True)
    "nss_scan_recur_serving": ("tpuir_torch/csrc/nss_scan.cu", "tpuir/ops/nss_stripe.py:218"),
}
MIXER_SERVING = ("mixer_prologue_serving", "nss_scan_serving", "mixer_epilogue_serving")
RECUR_SIGMA = 15  # the recur path's MaIR-CDN (the harness's sigma=15 row)
RECUR_MAIR_REQUESTS = [(200, 150), (96, 72)]
RECUR_UNET_REQUESTS = [(256, 256), (120, 90)]
HARNESS_IMAGES = [(96, 72), (64, 80)]  # one tile each for both models
HARNESS_PSNR_DB, HARNESS_SSIM = 0.01, 1e-3  # a harness row against its plain-path twin
# Phase 17, the plain-conv families: a BSD68-sized and a GoPro-sized request
# (H x W), the rounds each path serves, and the bound on |one patch alone -
# the same patch in a batch of 8| of a model's step output in [0, 1]
# (float32 noise: cuDNN may sum in another order at another batch).
PLAIN_BSD68 = (481, 321)
PLAIN_GOPRO = (720, 1280)
PLAIN_ROUNDS = 2
PLAIN_BATCH_TOL = 1e-4


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, exps: float = 0):
    """(least ms on the card, what bounds it) for work of nbytes, flops and
    ``exps`` exponentials on the special-function lanes (``mufu_ms``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / FP32_FLOP_PER_S, mufu_ms(exps) / 1e3)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mufu_ms(exps):
    """Least ms for ``exps`` exp2 on the special-function lanes,
    ``P1_OP_PER_S["exp2"]``: a scan's MUFU floor, one exp2 a state update."""
    return 1e3 * exps / P1_OP_PER_S["exp2"]


def bound_tc(nbytes: float, gemm_flops: float, flops: float) -> float:
    """Least ms on the card for work whose ``gemm_flops`` of ``flops`` run on
    the tensor cores in 3xTF32 and the rest at the float32 rate."""
    t_ops = gemm_flops / F32X3_FLOP_PER_S + (flops - gemm_flops) / FP32_FLOP_PER_S
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, t_ops)


def k1_products(batch, hw, C):
    """K1's four 1x1 products as (label, images, M, N, K, one weight an
    image): qkv, the folded projection (one C x C weight an image),
    project_in, project_out."""
    h, px = int(C * 2.66), batch * hw * hw
    return [("qkv", 1, px, 3 * C, C, False), ("proj", batch, hw * hw, C, C, True),
            ("ffn_in", 1, px, 2 * h, C, False), ("ffn_out", 1, px, C, h, False)]


def k1_work(batch, hw, C, heads, ln_bias=False):
    """(bytes, float32 operations) of one TransformerBlock: x in, out out,
    weights once; the 1x1 products, the depthwise convs, the Gram and the
    attention-weighted sum, the GELU gate."""
    h = int(C * 2.66)
    hc = C // heads
    px = batch * hw * hw
    weights = 3 * C * C + 27 * C + heads + C * C + 2 * h * C + 18 * h + h * C + 2 * C
    weights += 2 * C if ln_bias else 0
    nbytes = 4 * (2 * px * C + weights)
    flops = px * (2 * C * 3 * C + 18 * 3 * C + 4 * C * hc + 2 * C * C
                  + 2 * C * 2 * h + 18 * 2 * h + 8 * h + 2 * h * C)
    return nbytes, flops


def gemm_yardstick(label, images, M, N, K, per_image, device, seed):
    """The GEMM core alone (``ops/tc_gemm.gemm_f32x3``, 3xTF32) at one product
    shape, against float64 and beside ``torch.matmul`` in float32 (TF32 off)
    on the same seeded operands (unit-scale A, fan-in-scaled W): prints max
    |error|, its share of atol + rtol * |ref| and TFLOP/s of each; fails if
    the core misses the tolerance."""
    import torch

    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops.tc_gemm import gemm_f32x3

    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(images, M, K, device=device, generator=gen)
    w = torch.randn(*((images,) if per_image else ()), N, K, device=device,
                    generator=gen) * K ** -0.5
    with torch.inference_mode(), true_float32():
        mm = lambda: torch.matmul(a, w.transpose(-1, -2))  # noqa: E731
        core = lambda: gemm_f32x3(a, w)  # noqa: E731
        ref = torch.matmul(a.double(), w.double().transpose(-1, -2))
        stats = []
        for fn in (core, mm):
            err = (fn() - ref).abs()
            stats.append((err.max().item(), (err / (ATOL + RTOL * ref.abs())).max().item()))
            del err
        del ref
        core(), mm()
        t_mm = cuda_ms(mm, ITERS)
        t_core = (cuda_ms(core, ITERS) + cuda_ms(core, ITERS)) / 2
        t_mm = (t_mm + cuda_ms(mm, ITERS)) / 2
    tflop = 2 * images * M * N * K / 1e12
    print(f"  GEMM core {label:26s} {images}x({M}x{K} . {N}x{K}^T)  core {t_core:.3f} ms "
          f"{tflop / t_core * 1e3:6.1f} TFLOP/s max|err| {stats[0][0]:.2e} "
          f"({stats[0][1]:.3f} of tol)  torch.matmul f32 {t_mm:.3f} ms "
          f"{tflop / t_mm * 1e3:6.1f} TFLOP/s max|err| {stats[1][0]:.2e} ({stats[1][1]:.3f})",
          flush=True)
    if not stats[0][1] <= 1.0:
        fail(f"the GEMM core misses atol {ATOL:g} + rtol {RTOL:g} against float64 at {label}")


def prologue_work(px, dm, di):
    """K6: h in, x and z out, weights; in_proj, the depthwise conv, bias + SiLU."""
    return (4 * (px * dm + 2 * px * di + 2 * di * dm + 10 * di),
            px * (2 * dm * 2 * di + 18 * di + 5 * di))


def scan_work(px, di, n, r):
    """K2: x and the id table in, y (4 directions) and pooled out, weights;
    per direction and pixel the x_dbl and dt projections, softplus, per
    state update exp(dt*A), dt*B*x, the FMA into h and C.h, then D*x and
    the pooled sum. An exponential counts as one operation, and as one of
    the exponentials (the third value, one a state update)."""
    c = r + 2 * n
    nbytes = 4 * (px * di + 4 * px + 4 * px * di + 4 * (c * di + di * r + di * n + 2 * di))
    flops = 4 * px * (2 * c * di + 2 * r * di + 4 * di + 7 * di * n + 4 * di)
    return nbytes, flops, 4 * px * di * n


def k5_work(px, di, n, r):
    """K5: scan_work less the id table, which K5 does not read."""
    nbytes, flops, exps = scan_work(px, di, n, r)
    return nbytes - 4 * 4 * px, flops, exps


def k4_work(seqs, L, di, n):
    """K4: u and delta in, B and C in, y out (seqs = B*K sequences of L
    positions), A, D and the bias; per position and channel the bias add,
    softplus, D*u, and per state update exp(dt*A), dt*B*u, the FMA into h
    and C.h; one exponential a state update."""
    pos = seqs * L
    nbytes = 4 * (3 * pos * di + 2 * pos * n + seqs * (di * n + 2 * di))
    flops = pos * (5 * di + 7 * di * n + 2 * di)
    return nbytes, flops, pos * di * n


def k3_work(seqs, L, di, n, r):
    """K3: xs in, y out (seqs = B*4 sequences of L positions), weights; per
    position the x_dbl and dt projections, softplus, per state update
    exp(dt*A), dt*B*x, the FMA into h and C.h, then D*x; one exponential a
    state update."""
    c = r + 2 * n
    pos = seqs * L
    nbytes = 4 * (2 * pos * di + 4 * (c * di + di * r + di * n + 2 * di))
    flops = pos * (2 * c * di + 2 * r * di + 4 * di + 7 * di * n + 2 * di)
    return nbytes, flops, pos * di * n


def epilogue_work(px, di, dm, images):
    """K7: four direction images, z, gates and weights in, out out; the gated
    sum, LayerNorm, SiLU gate, out_proj."""
    return (4 * (4 * px * di + px * di + 4 * images * di + 2 * di + dm * di + px * dm),
            px * (8 * di + 8 * di + 6 * di + 2 * di * dm))


def timed_pair(kern, plain, iters=ITERS, plain_iters=None):
    """(kernel ms, plain ms) from CUDA events in turns: plain, kernel, kernel, plain."""
    plain_iters = plain_iters or iters
    kern(), plain()  # warm-up
    t_plain = cuda_ms(plain, plain_iters)
    t_kern = cuda_ms(kern, iters)
    t_kern = (t_kern + cuda_ms(kern, iters)) / 2
    t_plain = (t_plain + cuda_ms(plain, plain_iters)) / 2
    return t_kern, t_plain


def as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


def compare(got, want, atol, rtol):
    """(max |got - want|, whether every element of got is finite and within
    atol + rtol * |want|) over a tensor or a tuple of them."""
    import torch

    worst, ok = 0.0, True
    for g, w in zip(as_tuple(got), as_tuple(want)):
        err = (g - w).abs()
        worst = max(worst, err.max().item())
        ok &= bool((err <= atol + rtol * w.abs()).all().item()) and bool(
            torch.isfinite(g).all().item())
    return worst, ok


def compare_scan(got, want):
    """compare() for K2's (y, pooled): pooled is a sum over the path of
    values the two versions round differently, so its bound scales with the
    sum of |y| over the path, not with the sum itself."""
    import torch

    (y, pooled), (ry, rpooled) = got, want
    worst, ok = compare(y, ry, SCAN_ATOL, SCAN_RTOL)
    err = (pooled - rpooled).abs()
    ok &= bool((err <= SCAN_ATOL + SCAN_RTOL * ry.abs().sum((2, 3))).all().item()) and bool(
        torch.isfinite(pooled).all().item())
    return max(worst, err.max().item()), ok


def compare_fused(got, want):
    """compare_scan() for K5's (y01, y23, pooled)."""
    import torch

    (y01, y23, pooled), (r01, r23, rpooled) = got, want
    worst, ok = compare((y01, y23), (r01, r23), SCAN_ATOL, SCAN_RTOL)
    err = (pooled - rpooled).abs()
    sum_y = torch.cat([r01.abs().sum((2, 3)), r23.abs().sum((2, 3))], 1)
    ok &= bool((err <= SCAN_ATOL + SCAN_RTOL * sum_y).all().item()) and bool(
        torch.isfinite(pooled).all().item())
    return max(worst, err.max().item()), ok


def phase_kernel_vs_plain(device, batch=BATCH, shapes=BLOCK_SHAPES):
    """K1 against its plain version at each block shape, both LN variants.

    Before each shape, the GEMM core alone at K1's four product shapes
    (``gemm_yardstick``). Returns (max |delta|, per-forward kernel ms,
    per-forward plain ms, per-forward bound ms, what bounds it, per-forward
    3xTF32 bound ms), the per-forward figures summing each BiasFree shape's
    over its blocks.
    """
    import torch

    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.restormer import init_block_params
    from tpuir_torch.ops.fused_block import fused_transformer_block, fused_transformer_block_plain

    worst = 0.0
    fwd_ms = fwd_plain_ms = fwd_bytes = fwd_flops = fwd_gemm = 0.0
    with torch.inference_mode(), true_float32():
        for name, hw, C, heads, count in shapes:
            gemm = 0  # the four products' operations
            for label, images, M, N, K, per_image in k1_products(batch, hw, C):
                gemm_yardstick(f"K1 {name} {label}", images, M, N, K, per_image, device,
                               SEED + K)
                gemm += 2 * images * M * N * K
            for ln_bias in (False, True):
                p = {k: v.to(device) for k, v in
                     init_block_params(C, heads, ln_bias, SEED + C).items()}
                x = torch.from_numpy(
                    np.random.RandomState(SEED + hw).rand(batch, hw, hw, C).astype(np.float32)
                ).to(device).permute(0, 3, 1, 2)
                kern = lambda: fused_transformer_block(x, p, heads, ln_bias)  # noqa: E731
                plain = lambda: fused_transformer_block_plain(x, p, heads, ln_bias)  # noqa: E731
                got, want = kern(), plain()
                torch.cuda.synchronize()
                max_err, bound_ok = compare(got, want, ATOL, RTOL)
                del got, want
                t_kern, t_plain = timed_pair(kern, plain)
                nbytes, flops = k1_work(batch, hw, C, heads, ln_bias)
                b_ms, _ = bound(nbytes, flops)
                tc_ms = bound_tc(nbytes, gemm, flops)
                print(f"K1 {name:20s} B={batch} {hw}x{hw} C={C:3d} heads={heads} "
                      f"h={int(C * 2.66):4d} ln_bias={int(ln_bias)}  max|d|={max_err:.3e} "
                      f"(atol {ATOL:g} + rtol {RTOL:g}*|plain|: {'ok' if bound_ok else 'MISS'})  "
                      f"kernel {t_kern:.3f} ms  plain {t_plain:.3f} ms  bound {b_ms:.3f} ms "
                      f"(3xTF32: {tc_ms:.3f} ms)", flush=True)
                if not bound_ok:
                    fail(f"K1 disagrees with its plain version at {name} ln_bias={ln_bias}")
                worst = max(worst, max_err)
                if not ln_bias:
                    fwd_ms += count * t_kern
                    fwd_plain_ms += count * t_plain
                    fwd_bytes += count * nbytes
                    fwd_flops += count * flops
                    fwd_gemm += count * gemm
                del x, p
    return (worst, fwd_ms, fwd_plain_ms) + bound(fwd_bytes, fwd_flops) + (
        bound_tc(fwd_bytes, fwd_gemm, fwd_flops),)


def synthetic_image(h, w, seed):
    """A smooth uint8 test image (gradients plus a few discs), seeded."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([(yy / h), (xx / w), 0.5 + 0.5 * np.sin((xx + yy) / 23.0)], -1)
    for _ in range(6):
        cy, cx, r = rng.rand() * h, rng.rand() * w, 10 + rng.rand() * min(h, w) / 4
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.rand(3)
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


def noisy_image(clean, seed, sigma=UNET_NOISE):
    """A real-denoising input: clean plus seeded Gaussian noise, in uint8."""
    noise = np.random.RandomState(seed).randn(*clean.shape) * sigma
    return np.clip(np.round(clean + noise), 0, 255).astype(np.uint8)


def serve(model, images, sigma=SIGMA, targets=None):
    """Serve each image; with ``sigma`` the engine adds host AWGN, with
    ``sigma=None`` the image is served as it is. Scored against ``targets``
    (default: the images)."""
    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.core.metrics import calculate_metrics

    outs = []
    for img, ref in zip(images, targets or images):
        pred, t_ms = run_model_inference(
            model, img, patch_size=model.patch_size, patch_overlap=model.patch_overlap,
            need_degradation=sigma is not None, noise_level=sigma,
        )
        if pred.shape != img.shape or pred.dtype != np.uint8:
            fail(f"output {pred.shape} {pred.dtype} for input {img.shape} {img.dtype}")
        psnr, ssim = calculate_metrics(pred, ref)
        if not (np.isfinite(psnr) and np.isfinite(ssim)):
            fail(f"non-finite metrics {psnr} {ssim}")
        outs.append((pred, t_ms, psnr, ssim))
    return outs


def chunks_for(model, h, w) -> int:
    from tpuir_torch.core.tiling import tile_indices

    _, hs, ws = tile_indices(h, w, model.patch_size, model.patch_overlap)
    return -(-len(hs) * len(ws) // model.batch_size)


def plain_twin(model, net):
    """The same weights as ``model`` with plain blocks, on its device."""
    from tpuir_torch.core.engine import InferenceModel

    net.load_state_dict(model.net.state_dict())
    return InferenceModel(
        name=f"{model.name} (plain)", net=net.to(model.device).eval(), device=model.device,
        patch_size=model.patch_size, patch_overlap=model.patch_overlap,
        pad_factor=model.pad_factor, batch_size=model.batch_size,
        compute_dtype=model.compute_dtype,
    )


def serve_and_check(label, model, plain, cpu_model, requests, per_chunk, order,
                    sigma=SIGMA, kernel_only=()):
    """Serve ``requests`` on the kernel and plain paths in the given order of
    rounds (``kernel_only`` requests first, in the kernel rounds only), with
    the kernels' counts set to 0 just before and read just after; check the
    counts against ``per_chunk(h, w)`` ({kernel: launches a forward chunk}),
    repeatability, kernel vs plain and card vs CPU (on the last request).
    With ``sigma=None`` the inputs are noisy images served as they are.
    Returns ({kernel: launches}, {path: Mpix/s over ``requests``},
    {(h, w): (the kernel path's output, its median ms)} over every request)."""
    import torch

    from tpuir_torch.ops import _kernels

    sizes = list(kernel_only) + list(requests)
    clean = [synthetic_image(h, w, SEED + i) for i, (h, w) in enumerate(sizes)]
    images = clean if sigma is not None else [
        noisy_image(c, SEED + 100 + i) for i, c in enumerate(clean)]
    shared = slice(len(kernel_only), None)
    mpix = sum(h * w for h, w in requests) / 1e6
    serve(model, images[-1:], sigma)  # warm-up: cuDNN and allocator, not counted
    serve(plain, images[-1:], sigma)
    torch.cuda.synchronize()
    paths = {"kernel": (model, images, clean), "plain": (plain, images[shared], clean[shared])}
    served = {"kernel": [], "plain": []}
    _kernels.reset_launches()
    for name in order:
        net, imgs, refs = paths[name]
        served[name].append(serve(net, imgs, sigma, refs))
    rounds = order.count("kernel")
    want = {}
    for h, w in sizes:
        for k, n in per_chunk(h, w).items():
            want[k] = want.get(k, 0) + n * chunks_for(model, h, w) * rounds
    launches = {k: _kernels.LAUNCHES[k] for k in want}
    for k, n in launches.items():
        print(f"{label}: {k} launches {n} (expected {want[k]} over {rounds} rounds of "
              f"{', '.join(f'{h}x{w}' for h, w in sizes)})", flush=True)
        if n != want[k]:
            fail(f"{k} launched {n} times on the {label} path, expected {want[k]}")

    for i, (h, w) in enumerate(kernel_only):
        pred, _, psnr, ssim = served["kernel"][0][i]
        if any(not np.array_equal(rnd[i][0], pred) for rnd in served["kernel"]):
            fail(f"the {label} kernel path is not repeatable on {h}x{w}")
        ms = float(np.median([rnd[i][1] for rnd in served["kernel"]]))
        print(f"{label} request {h}x{w}x3: PSNR {psnr:.4f} dB SSIM {ssim:.5f}  kernel path "
              f"{ms:.1f} ms {h * w / 1e3 / ms:.3f} Mpix/s (kernel path only)", flush=True)
    kernel_rounds = [rnd[shared] for rnd in served["kernel"]]
    total = {"kernel": 0.0, "plain": 0.0}
    for i, (h, w) in enumerate(requests):
        pred, _, psnr, ssim = kernel_rounds[0][i]
        ppred = served["plain"][0][i]
        if any(not np.array_equal(rnd[i][0], pred) for rnd in kernel_rounds):
            fail(f"the {label} kernel path is not repeatable on {h}x{w}")
        ms = {"kernel": float(np.median([rnd[i][1] for rnd in kernel_rounds])),
              "plain": float(np.median([rnd[i][1] for rnd in served["plain"]]))}
        lsb = int(np.abs(pred.astype(int) - ppred[0].astype(int)).max())
        for k in total:
            total[k] += ms[k]
        print(f"{label} request {h}x{w}x3: PSNR {psnr:.4f} dB SSIM {ssim:.5f}  kernel path "
              f"{ms['kernel']:.1f} ms {h * w / 1e3 / ms['kernel']:.3f} Mpix/s  plain path "
              f"{ms['plain']:.1f} ms {h * w / 1e3 / ms['plain']:.3f} Mpix/s  "
              f"max|kernel-plain| {lsb} LSB", flush=True)
        if lsb > 1:
            fail(f"{label}: kernel and plain paths differ by {lsb} uint8 LSB on {h}x{w}")

    # the last request once more, on the CPU: an independent float32 reference
    (cpu_pred, _, _, _), = serve(cpu_model, images[-1:], sigma, clean[-1:])
    lsb = int(np.abs(cpu_pred.astype(int) - served["kernel"][0][-1][0].astype(int)).max())
    print(f"{label} request {requests[-1][0]}x{requests[-1][1]}x3 card vs CPU: max {lsb} LSB",
          flush=True)
    if lsb > 1:
        fail(f"{label}: card and CPU differ by {lsb} uint8 LSB")
    rate = {k: mpix / (v / 1e3) for k, v in total.items()}
    print(f"{label} engine over the {len(requests)} requests ({mpix:.4f} Mpix): kernel path "
          f"{rate['kernel']:.3f} Mpix/s, plain path {rate['plain']:.3f} Mpix/s", flush=True)
    outs = {hw: (served["kernel"][0][i][0],
                 float(np.median([rnd[i][1] for rnd in served["kernel"]])))
            for i, hw in enumerate(sizes)}
    return launches, rate, outs


def phase_main_path(device, requests=REQUESTS):
    """Serve Restormer on the kernel and plain paths; returns
    ({"fused_transformer_block": launches}, {path: Mpix/s}, outputs)."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.restormer import Restormer, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "Restormer", "denoising", "gaussian_color_denoising_sigma25.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False,
                                       sigma=SIGMA, weights_dir=wdir, device=device)
        cpu_model = zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False,
                                           sigma=SIGMA, weights_dir=wdir, device="cpu")
    print(f"main path: Restormer color sigma={SIGMA}, {model.param_count:,} params, "
          f"patch {model.patch_size} overlap {model.patch_overlap} batch {model.batch_size}",
          flush=True)
    plain = plain_twin(model, Restormer(**CONFIG, fused=False))
    # ROUNDS rounds, the two paths in turns (k p, p k, k p)
    order = [n for r in range(ROUNDS) for n in (("kernel", "plain") if r % 2 == 0
                                                else ("plain", "kernel"))]
    return serve_and_check("Restormer", model, plain, cpu_model, requests,
                           lambda h, w: {"fused_transformer_block": 44}, order)


def mixer_weights(sd, prefix, device):
    """A mixer's weights (its keys under ``prefix``) on ``device``, with its
    widths: (weights, d_model, d_inner, d_state)."""
    w = {k[len(prefix):]: v.to(device) for k, v in sd.items() if k.startswith(prefix)}
    two_di, dm = w["in_proj.weight"].shape
    return w, dm, two_di // 2, w["A_logs"].shape[1]


def mixer_operands(w, batch, hw, seed):
    """The operands of K6, K2 and K7 for mixer weights ``w`` on a unit-scale
    input of (batch, H, W), made by the plain versions: (prologue args,
    scan kwargs, epilogue kwargs, {kernel: its plain output}, {kernel: its
    plain version's ms}, each call timed once from CUDA events)."""
    import torch

    from tpuir_torch.ops.nss_epilogue import mixer_epilogue_plain
    from tpuir_torch.ops.nss_prologue import mixer_prologue_plain
    from tpuir_torch.ops.nss_stripe import nss_scan_plain

    want, plain_ms = {}, {}

    def timed(name, fn, *args, **kw):
        out = []
        plain_ms[name] = cuda_ms(lambda: out.append(fn(*args, **kw)), 1)
        want[name] = out[0]
        return out[0]

    di, dm = w["in_proj.weight"].shape[0] // 2, w["in_proj.weight"].shape[1]
    n = w["A_logs"].shape[1]
    h_img, w_img = hw
    device = w["in_proj.weight"].device
    h = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        batch, h_img, w_img, dm).astype(np.float32)).to(device)
    pro = (h, w["in_proj.weight"], w["conv2d.weight"], w["conv2d.bias"])
    x, z = timed("mixer_prologue", mixer_prologue_plain, *pro)
    scan = dict(x=x, x_proj_w=w["x_proj_weight"], dt_w=w["dt_projs_weight"],
                A=-torch.exp(w["A_logs"]).reshape(4, di, n), D=w["Ds"].reshape(4, di),
                delta_bias=w["dt_projs_bias"])
    y, pooled = timed("nss_scan", nss_scan_plain, **scan)
    gw = w["gating.gating.1.weight"].reshape(di, 4, 4)
    gb = w["gating.gating.1.bias"].reshape(di, 4)
    gates = torch.sigmoid(torch.einsum("bid,doi->bod", pooled / (h_img * w_img), gw)
                          + gb.t()[None]).contiguous()
    epi = dict(y=y, gates=gates, z=z, ln_w=w["out_norm.weight"], ln_b=w["out_norm.bias"],
               w_out=w["out_proj.weight"])
    timed("mixer_epilogue", mixer_epilogue_plain, **epi)
    return pro, scan, epi, want, plain_ms


def mixer_inputs(device, batch, hw, seed=SEED):
    """Seeded MaIR-CDN mixer weights (block 0 of the released layout) and the
    activations the plain mixer makes from a unit-scale input of (batch, H, W)."""
    from tpuir_torch import zoo
    from tpuir_torch.models.mair import init_state_dict

    w, _, _, _ = mixer_weights(init_state_dict(zoo.MAIR_CDN_CONFIG, seed=seed),
                               "layers.0.residual_group.blocks.0.self_attention.", device)
    return mixer_operands(w, batch, hw, seed)[:3]


def phase_mair_kernels(device):
    """K6, K2 and K7 against their plain versions at MaIR-CDN@128, batch 8
    (K2 also at the 96x72 tile, batch 1), after the GEMM core alone at K6's
    in_proj shape (``gemm_yardstick``). Returns {kernel: (max|d|, ms, plain
    ms, bound ms, bound by)}, each per call at batch 8, 128x128 (K2: the
    mean over both shifts)."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops.nss_epilogue import mixer_epilogue, mixer_epilogue_plain
    from tpuir_torch.ops.nss_prologue import mixer_prologue, mixer_prologue_plain
    from tpuir_torch.ops.nss_stripe import nss_scan, nss_scan_plain

    cfg = zoo.MAIR_CDN_CONFIG
    dm = cfg["embed_dim"]
    di = int(cfg["ssm_ratio"] * dm)
    n, r = cfg["d_state"], -(-dm // 16)
    res = {}
    with torch.inference_mode(), true_float32():
        t = MAIR_TILE
        pro, scan, epi = mixer_inputs(device, BATCH, (t, t))
        px = BATCH * t * t
        gemm_yardstick(f"K6 MaIR-CDN@{t} in_proj", 1, px, 2 * di, dm, False, device, SEED)
        gemm_yardstick(f"K7 MaIR-CDN@{t} out_proj", 1, px, dm, di, False, device, SEED)
        plain_bound = lambda g, w: compare(g, w, ATOL, RTOL)  # noqa: E731
        cases = [
            ("mixer_prologue", f"K6 B={BATCH} {t}x{t}", lambda: mixer_prologue(*pro),
             lambda: mixer_prologue_plain(*pro), plain_bound, ITERS, ITERS,
             prologue_work(px, dm, di)),
            ("mixer_epilogue", f"K7 B={BATCH} {t}x{t}", lambda: mixer_epilogue(**epi),
             lambda: mixer_epilogue_plain(**epi), plain_bound, ITERS, ITERS,
             epilogue_work(px, di, dm, BATCH)),
        ]
        for shift in (False, True):
            cases.append((
                "nss_scan", f"K2 B={BATCH} {t}x{t} shift={int(shift)}",
                lambda shift=shift: nss_scan(**scan, shift=shift),
                lambda shift=shift: nss_scan_plain(**scan, shift=shift),
                compare_scan, 3, 1, scan_work(px, di, n, r)))
        for name, label, kern, plain, check, iters, plain_iters, work in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            max_err, ok = check(got, want)
            del got, want
            t_kern, t_plain = timed_pair(kern, plain, iters, plain_iters)
            b_ms, b_by = bound(*work)
            tol = (f"atol {SCAN_ATOL:g} + rtol {SCAN_RTOL:g}*|plain| (pooled: *sum|y|)"
                   if name == "nss_scan" else f"atol {ATOL:g} + rtol {RTOL:g}*|plain|")
            print(f"{label:26s} max|d|={max_err:.3e} ({tol}: {'ok' if ok else 'MISS'})  "
                  f"kernel {t_kern:.3f} ms  plain {t_plain:.3f} ms  bound {b_ms:.3f} ms ({b_by})",
                  flush=True)
            if not ok:
                fail(f"{label} disagrees with its plain version")
            prev = res.get(name)
            row = (max_err, t_kern, t_plain, b_ms, b_by)
            if prev:  # K2: the mean over both shifts
                row = (max(prev[0], max_err), (prev[1] + t_kern) / 2, (prev[2] + t_plain) / 2,
                       b_ms, b_by)
            res[name] = row
        del pro, scan, epi

        # the rectangular tile the 96x72 request gives (K2a's case)
        _, scan, _ = mixer_inputs(device, 1, (96, 72))
        for shift in (False, True):
            got = nss_scan(**scan, shift=shift)
            want = nss_scan_plain(**scan, shift=shift)
            torch.cuda.synchronize()
            max_err, ok = compare_scan(got, want)
            print(f"K2 B=1 96x72 shift={int(shift)}      max|d|={max_err:.3e} "
                  f"({'ok' if ok else 'MISS'})", flush=True)
            if not ok:
                fail(f"K2 disagrees with its plain version at 96x72 shift={shift}")
            res["nss_scan"] = (max(res["nss_scan"][0], max_err),) + res["nss_scan"][1:]
    return res


def phase_mair_path(device, requests=MAIR_REQUESTS):
    """Serve MaIR-CDN on the kernel and plain paths; returns
    ({kernel: launches}, {path: Mpix/s}, {(h, w): (kernel output, ms)})."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair import MaIR, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{SIGMA}.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(zoo.MAIR_CDN_CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                       weights_dir=wdir, device=device)
        cpu_model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                           weights_dir=wdir, device="cpu")
    print(f"main path: MaIR-CDN sigma={SIGMA}, {model.param_count:,} params, "
          f"patch {model.patch_size} overlap {model.patch_overlap} batch {model.batch_size}",
          flush=True)
    plain = plain_twin(model, MaIR(**zoo.MAIR_CDN_CONFIG, fused=False))
    # the plain scan is slow: one plain round between the kernel rounds
    order = ["kernel", "plain"] + ["kernel"] * (ROUNDS - 1)
    per_chunk = dict.fromkeys(("mixer_prologue", "nss_scan", "mixer_epilogue"), MAIR_BLOCKS)
    return serve_and_check("MaIR", model, plain, cpu_model, requests, lambda h, w: per_chunk,
                           order)


def check_case(label, kern, want, check, iters, plain_ms, work, repeat=False):
    """Run kern once against the plain result ``want`` (and, with
    ``repeat``, once more for bit-for-bit repeatability), time it from CUDA
    events, print one line and fail on a miss. Returns (max|d|, kernel ms,
    plain ms, bound ms, bound by)."""
    import torch

    got = kern()
    torch.cuda.synchronize()
    max_err, ok = check(got, want)
    if repeat and not all(map(torch.equal, as_tuple(got), as_tuple(kern()))):
        fail(f"{label} does not repeat bit for bit")
    del got
    t_kern = cuda_ms(kern, iters)
    b_ms, b_by = bound(*work)
    print(f"{label:34s} max|d|={max_err:.3e} ({'ok' if ok else 'MISS'})  kernel {t_kern:.3f} ms  "
          f"plain {plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return max_err, t_kern, plain_ms, b_ms, b_by


def phase_unet_kernels(device):
    """K6, K2 and K7 at MaIRUNet's five level shapes of a 384x384 tile at
    batch 8, K2 at the 384x328 tile (batch 2), and K3 at the 481x321
    request's two K3 levels (batch 2), each against its plain version (TF32
    off), the plain version timed once a shape. Returns ({kernel: max|d|},
    {row label: (max|d|, ms, plain ms, bound ms, bound by)}, K3's row per
    forward chunk of the 481x321 request, K3's state updates a chunk). The
    GEMM core alone runs at each level's in_proj shape first
    (``gemm_yardstick``)."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.mair_unet import init_state_dict
    from tpuir_torch.ops.nss_epilogue import mixer_epilogue
    from tpuir_torch.ops.nss_prologue import mixer_prologue
    from tpuir_torch.ops.nss_stripe import nss_scan
    from tpuir_torch.ops.scan_fused_proj import (selective_scan_fused_proj,
                                                 selective_scan_fused_proj_plain)
    from tpuir_torch.ops.scan_ids import scan_index_tensors

    sd = init_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)
    worst, rows = {}, {}
    tc_fwd = {"K6": 0.0, "K7": 0.0}  # the 3xTF32 bounds per forward
    plain_bound = lambda g, w: compare(g, w, ATOL, RTOL)  # noqa: E731
    scan_bound = lambda g, w: compare(g, w, SCAN_ATOL, SCAN_RTOL)  # noqa: E731

    def keep(name, label, row):
        worst[name] = max(worst.get(name, 0.0), row[0])
        rows[label] = row

    with torch.inference_mode(), true_float32():
        cases = [(label, t, t, stage, BATCH) for label, t, stage, _ in UNET_LEVELS]
        cases.append(("rect", UNET_RECT[0], UNET_RECT[1], UNET_RECT[2], 2))
        for label, hh, ww, stage, batch in cases:
            w, dm, di, n = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            r = w["dt_projs_weight"].shape[-1]
            px = batch * hh * ww
            pro, scan, epi, want, plain_ms = mixer_operands(w, batch, (hh, ww), SEED)
            tag = f"B={batch} {hh}x{ww} Dm={dm} Di={di} N={n}"
            if label != "rect":
                gemm_yardstick(f"K6 MaIRUNet {label} in_proj", 1, px, 2 * di, dm, False, device,
                               SEED)
                gemm_yardstick(f"K7 MaIRUNet {label} out_proj", 1, px, dm, di, False, device,
                               SEED)
                calls = dict((lb, c) for lb, _, _, c in UNET_LEVELS)[label]
                for short, (nbytes, flops), gemm in (
                        ("K6", prologue_work(px, dm, di), px * 4 * dm * di),
                        ("K7", epilogue_work(px, di, dm, batch), px * 2 * di * dm)):
                    tc_fwd[short] += calls * bound_tc(nbytes, gemm, flops)
            kernels = [
                ("mixer_prologue", "K6", lambda: mixer_prologue(*pro), plain_bound,
                 prologue_work(px, dm, di)),
                ("nss_scan", "K2", lambda: nss_scan(**scan), compare_scan,
                 scan_work(px, di, n, r)),
                ("mixer_epilogue", "K7", lambda: mixer_epilogue(**epi), plain_bound,
                 epilogue_work(px, di, dm, batch)),
            ]
            for name, short, kern, check, work in kernels:
                if label == "rect" and name != "nss_scan":
                    continue  # the rectangular tile is K2a's case
                keep(name, f"{short} {label}", check_case(
                    f"{short} {tag}", kern, want[name], check, 3, plain_ms[name], work,
                    repeat=name == "nss_scan"))
            del pro, scan, epi, want, kernels
            torch.cuda.empty_cache()
        for short in ("K6", "K2", "K7"):
            fwd = [(count, rows[f"{short} {label}"]) for label, _, _, count in UNET_LEVELS]
            print(f"{short} per MaIRUNet@384 forward (batch {BATCH}, "
                  f"{sum(c for c, _ in fwd)} calls): kernel {sum(c * r[1] for c, r in fwd):.3f} "
                  f"ms, plain {sum(c * r[2] for c, r in fwd):.3f} ms, bound "
                  f"{sum(c * r[3] for c, r in fwd):.3f} ms"
                  + (f" (3xTF32: {tc_fwd[short]:.3f} ms)" if short in tc_fwd else ""), flush=True)

        k3_ms = k3_plain = k3_bytes = k3_flops = 0.0
        k3_updates = 0
        for label, hh, ww, stage, count in UNET_K3_LEVELS:
            w, dm, di, n = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            r = w["dt_projs_weight"].shape[-1]
            _, scan, _, _, _ = mixer_operands(w, 2, (hh, ww), SEED)
            ids, _ = scan_index_tensors(hh, ww, 4, 0, device)
            L = hh * ww
            xs = scan["x"].reshape(2, L, di)[:, ids]
            args = (xs, scan["x_proj_w"], scan["dt_w"], scan["A"], scan["D"],
                    scan["delta_bias"])
            want = []
            plain_ms = cuda_ms(lambda: want.append(selective_scan_fused_proj_plain(*args)), 1)
            work = k3_work(2 * 4, L, di, n, r)
            row = check_case(f"K3 B=2 {hh}x{ww} Di={di} N={n}",
                             lambda: selective_scan_fused_proj(*args), want[0], scan_bound, 10,
                             plain_ms, work, repeat=True)
            updates = work[2]
            print(f"{'':34s} MUFU floor {mufu_ms(updates):.4f} ms (one exp2 a state update, "
                  f"{updates:,} updates)", flush=True)
            keep("selective_scan_fused_proj", f"K3 {label}", row)
            k3_ms += count * row[1]
            k3_plain += count * row[2]
            k3_bytes += count * work[0]
            k3_flops += count * work[1]
            k3_updates += count * updates
            del scan, xs, args, want
    k3_row = ((worst["selective_scan_fused_proj"], k3_ms, k3_plain)
              + bound(k3_bytes, k3_flops, k3_updates))
    print(f"K3 per forward chunk of the 481x321 request (12 calls at 96x82, 8 at 48x41, "
          f"batch 2): kernel {k3_ms:.3f} ms, plain {k3_plain:.3f} ms, bound {k3_row[3]:.3f} ms "
          f"({k3_row[4]}), MUFU floor {mufu_ms(k3_updates):.3f} ms", flush=True)
    return worst, rows, k3_row, k3_updates


def unet_per_chunk(model, fused=False, serving=False):
    """{kernel: launches a forward chunk} of MaIRUNet for an h x w request:
    each stage's blocks on K6, K2 and K7 (with ``fused``: on K5) where its
    level's H and W are multiples of scan_len 4 (so even), else on K3, as
    the JAX module routes them (``tpuir/models/mair.py:196-213``); with
    ``serving``, their serving bodies."""
    from tpuir_torch.core.tiling import tile_indices

    def per_chunk(h, w):
        ps, _, _ = tile_indices(h, w, model.patch_size, model.patch_overlap)
        ph, pw = (-(-min(ps, s) // model.pad_factor) * model.pad_factor for s in (h, w))
        on_level = ("nss_scan_fused",) if fused else ("mixer_prologue", "nss_scan",
                                                      "mixer_epilogue")
        suffix = "_serving" if serving else ""
        out = {k + suffix: 0 for k in on_level + ("selective_scan_fused_proj",)}
        for stage, lvl in UNET_STAGES:
            n = len(getattr(model.net, stage))
            if (ph >> lvl) % 4 == 0 and (pw >> lvl) % 4 == 0:
                for k in on_level:
                    out[k + suffix] += n
            else:
                out["selective_scan_fused_proj" + suffix] += n
        return out

    return per_chunk


def phase_unet_path(device):
    """Serve MaIRUNet (real denoising) on the kernel and plain paths; returns
    ({kernel: launches}, {path: Mpix/s}, {(h, w): (kernel output, ms)})."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair_unet import MaIRUNet, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "MaIR", "denoising", "MaIR_RealDN.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "real", "MaIR", weights_dir=wdir,
                                       device=device)
        cpu_model = zoo.get_model_instance("denoising", "real", "MaIR", weights_dir=wdir,
                                           device="cpu")
    print(f"main path: MaIRUNet real denoising, {model.param_count:,} params, "
          f"patch {model.patch_size} overlap {model.patch_overlap} batch {model.batch_size}",
          flush=True)
    per_chunk = unet_per_chunk(model)
    for h, w in UNET_KERNEL_ONLY + UNET_REQUESTS:
        print(f"MaIRUNet {h}x{w}: {chunks_for(model, h, w)} chunks, per chunk "
              f"{per_chunk(h, w)}", flush=True)
    plain = plain_twin(model, MaIRUNet(**zoo.MAIR_UNET_CONFIG, fused=False))
    # the plain scan is slow: one plain round between the kernel rounds
    order = ["kernel", "plain"] + ["kernel"] * (ROUNDS - 1)
    return serve_and_check("MaIRUNet", model, plain, cpu_model, UNET_REQUESTS, per_chunk,
                           order, sigma=None, kernel_only=UNET_KERNEL_ONLY)


def scan_operands(w, batch, hw, seed):
    """K2's and K5's operands for mixer weights ``w``: x from the plain
    prologue on a unit-scale input of (batch, H, W), and the scan weights."""
    import torch

    from tpuir_torch.ops.nss_prologue import mixer_prologue_plain

    di, dm = w["in_proj.weight"].shape[0] // 2, w["in_proj.weight"].shape[1]
    n = w["A_logs"].shape[1]
    h = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        batch, hw[0], hw[1], dm).astype(np.float32)).to(w["in_proj.weight"].device)
    x, _ = mixer_prologue_plain(h, w["in_proj.weight"], w["conv2d.weight"], w["conv2d.bias"])
    return dict(x=x, x_proj_w=w["x_proj_weight"], dt_w=w["dt_projs_weight"],
                A=-torch.exp(w["A_logs"]).reshape(4, di, n), D=w["Ds"].reshape(4, di),
                delta_bias=w["dt_projs_bias"])


def phase_fused_kernels(device):
    """K5 against its plain version (TF32 off): MaIR-CDN@128 at batch 8 with
    the shift off and on (timed in turns, plain kernel kernel plain), the
    96x72 tile at batch 1, MaIRUNet's five level shapes of a 384x384 tile
    at batch 8 and the 384x328 tile at batch 2 (the plain version timed once
    a shape); it must repeat bit for bit. Returns (max|d|, ms, plain ms,
    bound ms, bound by), per call at MaIR-CDN@128, the mean over both
    shifts."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.mair_unet import init_state_dict
    from tpuir_torch.ops.nss_fused import nss_scan_fused, nss_scan_fused_plain

    cfg = zoo.MAIR_CDN_CONFIG
    dm = cfg["embed_dim"]
    di, n, r = int(cfg["ssm_ratio"] * dm), cfg["d_state"], -(-dm // 16)
    worst, cdn = 0.0, []
    with torch.inference_mode(), true_float32():
        t = MAIR_TILE
        _, scan, _ = mixer_inputs(device, BATCH, (t, t))
        for shift in (False, True):
            kern = lambda shift=shift: nss_scan_fused(**scan, shift=shift)  # noqa: E731
            plain = lambda shift=shift: nss_scan_fused_plain(**scan, shift=shift)  # noqa: E731
            got, want = kern(), plain()
            torch.cuda.synchronize()
            max_err, ok = compare_fused(got, want)
            if not all(map(torch.equal, got, kern())):
                fail(f"K5 at {t}x{t} shift={shift} does not repeat bit for bit")
            del got, want
            t_kern, t_plain = timed_pair(kern, plain, 3, 1)
            b_ms, b_by = bound(*k5_work(BATCH * t * t, di, n, r))
            print(f"K5 B={BATCH} {t}x{t} shift={int(shift)}      max|d|={max_err:.3e} "
                  f"({'ok' if ok else 'MISS'})  kernel {t_kern:.3f} ms  plain {t_plain:.3f} ms  "
                  f"bound {b_ms:.3f} ms ({b_by})", flush=True)
            if not ok:
                fail(f"K5 disagrees with its plain version at {t}x{t} shift={shift}")
            worst = max(worst, max_err)
            cdn.append((t_kern, t_plain, b_ms, b_by))
        del scan
        # the rectangular tile the 96x72 request gives: y23 is 72x96
        _, scan, _ = mixer_inputs(device, 1, (96, 72))
        for shift in (False, True):
            got = nss_scan_fused(**scan, shift=shift)
            max_err, ok = compare_fused(got, nss_scan_fused_plain(**scan, shift=shift))
            print(f"K5 B=1 96x72 shift={int(shift)}      max|d|={max_err:.3e} "
                  f"({'ok' if ok else 'MISS'})", flush=True)
            if not ok:
                fail(f"K5 disagrees with its plain version at 96x72 shift={shift}")
            worst = max(worst, max_err)
        del scan

        sd = init_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)
        cases = [(label, tt, tt, stage, BATCH, count) for label, tt, stage, count in UNET_LEVELS]
        cases.append(("rect", UNET_RECT[0], UNET_RECT[1], UNET_RECT[2], 2, 0))
        fwd = [0.0, 0.0, 0.0]
        for label, hh, ww, stage, batch, count in cases:
            w, dm_, di_, n_ = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            scan = scan_operands(w, batch, (hh, ww), SEED)
            want = []
            plain_ms = cuda_ms(lambda: want.append(nss_scan_fused_plain(**scan)), 1)
            row = check_case(f"K5 B={batch} {hh}x{ww} Dm={dm_} Di={di_} N={n_}",
                             lambda: nss_scan_fused(**scan), want[0], compare_fused, 3, plain_ms,
                             k5_work(batch * hh * ww, di_, n_, w["dt_projs_weight"].shape[-1]),
                             repeat=True)
            worst = max(worst, row[0])
            for i in range(3):
                fwd[i] += count * row[1 + i]
            del scan, want
            torch.cuda.empty_cache()
        print(f"K5 per MaIRUNet@384 forward on the fused route (batch {BATCH}, "
              f"{sum(c for *_, c in cases)} calls): kernel {fwd[0]:.3f} ms, plain {fwd[1]:.3f} ms, "
              f"bound {fwd[2]:.3f} ms", flush=True)
    mean = lambda i: sum(c[i] for c in cdn) / len(cdn)  # noqa: E731
    return worst, mean(0), mean(1), mean(2), cdn[0][3]


def serve_kernel_rounds(label, model, images, sizes, per_chunk, sigma, refs=None):
    """Serve ``images`` ROUNDS times on ``model`` with the kernels' counts
    set to 0 just before and read just after; check the counts against
    ``per_chunk(h, w)`` (kernels not named there must not launch) and
    repeatability. Returns ({kernel: launches}, [(output, median ms)])."""
    import torch

    from tpuir_torch.ops import _kernels

    serve(model, images[-1:], sigma, (refs or images)[-1:])  # warm-up, not counted
    torch.cuda.synchronize()
    _kernels.reset_launches()
    rounds = [serve(model, images, sigma, refs) for _ in range(ROUNDS)]
    launches = dict(_kernels.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    for h, w in sizes:
        for k, n in per_chunk(h, w).items():
            want[k] += n * chunks_for(model, h, w) * ROUNDS
    for k, n in launches.items():
        if n or want[k]:
            print(f"{label}: {k} launches {n} (expected {want[k]} over {ROUNDS} rounds of "
                  f"{', '.join(f'{h}x{w}' for h, w in sizes)})", flush=True)
        if n != want[k]:
            fail(f"{k} launched {n} times on the {label} path, expected {want[k]}")
    outs = []
    for i, (h, w) in enumerate(sizes):
        pred = rounds[0][i][0]
        if any(not np.array_equal(rnd[i][0], pred) for rnd in rounds):
            fail(f"the {label} kernel path is not repeatable on {h}x{w}")
        outs.append((pred, float(np.median([rnd[i][1] for rnd in rounds]))))
    return {k: n for k, n in launches.items() if n}, outs


def lsb(a, b) -> int:
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def phase_fused_path(device, mair_stripe, unet_stripe):
    """Serve MaIR-CDN and MaIRUNet built with ``nss="fused"``: MaIR-CDN's
    three requests (36 K5 launches a chunk, no K6, K2 or K7) within 1 LSB of
    the stripe route's kernel outputs ``mair_stripe`` ({(h, w): (output,
    ms)}), of the fused route's plain path and of the CPU on 96x72; MaIRUNet's
    481x321 request (24 K5 and 20 K3 launches a chunk) within 1 LSB of
    ``unet_stripe``. Returns {kernel: launches}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair import MaIR
    from tpuir_torch.models.mair import init_state_dict as mair_state_dict
    from tpuir_torch.models.mair_unet import init_state_dict as unet_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        os.makedirs(os.path.join(wdir, "MaIR", "denoising"))
        torch.save({"params": mair_state_dict(zoo.MAIR_CDN_CONFIG, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{SIGMA}.pth"))
        torch.save({"params": unet_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", "MaIR_RealDN.pth"))
        model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                       weights_dir=wdir, device=device, nss="fused")
        cpu_model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                           weights_dir=wdir, device="cpu", nss="fused")
        unet = zoo.get_model_instance("denoising", "real", "MaIR", weights_dir=wdir,
                                      device=device, nss="fused")
    print(f"fused route: MaIR-CDN sigma={SIGMA} and MaIRUNet real denoising, nss=fused",
          flush=True)
    images = [synthetic_image(h, w, SEED + i) for i, (h, w) in enumerate(MAIR_REQUESTS)]
    launches, outs = serve_kernel_rounds(
        "MaIR-CDN fused", model, images, MAIR_REQUESTS,
        lambda h, w: {"nss_scan_fused": MAIR_BLOCKS}, SIGMA)
    for (h, w), (pred, ms) in zip(MAIR_REQUESTS, outs):
        diff = lsb(pred, mair_stripe[(h, w)][0])
        print(f"MaIR-CDN fused request {h}x{w}x3: kernel path {ms:.1f} ms "
              f"{h * w / 1e3 / ms:.3f} Mpix/s (stripe route {mair_stripe[(h, w)][1]:.1f} ms)  "
              f"max|fused-stripe| {diff} LSB", flush=True)
        if diff > 1:
            fail(f"the fused and stripe routes differ by {diff} uint8 LSB on {h}x{w}")
    mpix = sum(h * w for h, w in MAIR_REQUESTS) / 1e6
    rate = mpix / (sum(ms for _, ms in outs) / 1e3)
    stripe_rate = mpix / (sum(mair_stripe[hw][1] for hw in MAIR_REQUESTS) / 1e3)
    print(f"MaIR-CDN engine over the {len(MAIR_REQUESTS)} requests ({mpix:.4f} Mpix): fused "
          f"route {rate:.3f} Mpix/s, stripe route {stripe_rate:.3f} Mpix/s", flush=True)
    # the last request on the fused route's plain path and on the CPU
    plain = plain_twin(model, MaIR(**zoo.MAIR_CDN_CONFIG, fused=False, nss="fused"))
    for name, net in (("plain path", plain), ("CPU", cpu_model)):
        (pred, _, _, _), = serve(net, images[-1:], SIGMA)
        diff = lsb(pred, outs[-1][0])
        h, w = MAIR_REQUESTS[-1]
        print(f"MaIR-CDN fused request {h}x{w}x3 kernel path vs {name}: max {diff} LSB",
              flush=True)
        if diff > 1:
            fail(f"the fused route's kernel path and {name} differ by {diff} LSB on {h}x{w}")
    del model, plain, cpu_model

    h, w = UNET_FUSED_REQUEST
    i = (UNET_KERNEL_ONLY + UNET_REQUESTS).index(UNET_FUSED_REQUEST)  # phase 7's image
    clean = synthetic_image(h, w, SEED + i)
    img = noisy_image(clean, SEED + 100 + i)
    per_chunk = unet_per_chunk(unet, fused=True)
    print(f"MaIRUNet fused {h}x{w}: {chunks_for(unet, h, w)} chunks, per chunk "
          f"{per_chunk(h, w)}", flush=True)
    unet_launches, ((pred, ms),) = serve_kernel_rounds(
        "MaIRUNet fused", unet, [img], [UNET_FUSED_REQUEST], per_chunk, None, [clean])
    diff = lsb(pred, unet_stripe[UNET_FUSED_REQUEST][0])
    print(f"MaIRUNet fused request {h}x{w}x3: kernel path {ms:.1f} ms {h * w / 1e3 / ms:.3f} "
          f"Mpix/s (stripe route {unet_stripe[UNET_FUSED_REQUEST][1]:.1f} ms, "
          f"{h * w / 1e3 / unet_stripe[UNET_FUSED_REQUEST][1]:.3f} Mpix/s)  "
          f"max|fused-stripe| {diff} LSB", flush=True)
    if diff > 1:
        fail(f"MaIRUNet's fused and stripe routes differ by {diff} uint8 LSB on {h}x{w}")
    for k, n in unet_launches.items():
        launches[k] = launches.get(k, 0) + n
    return launches


def phase_selective_scan(device):
    """K4: its entry point driven once on each of K4_CASES with the counts
    set to 0 just before and read just after, then each output held against
    ``selective_scan`` (TF32 off), repeated bit for bit and timed (CUDA
    events; plain once). Returns (launches, (max|d|, ms, plain ms, bound ms,
    bound by) at MaIR-CDN's shape)."""
    import torch

    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops import _kernels
    from tpuir_torch.ops.selective_scan import selective_scan, selective_scan_kernel

    gen = torch.Generator(device=device).manual_seed(SEED)

    def operands(b, k, L, d, n, with_d):
        f = lambda *s: torch.randn(*s, device=device, generator=gen)  # noqa: E731
        return dict(u=f(b, k, L, d), delta=f(b, k, L, d) * 0.5,
                    A=-torch.exp(f(k, d, n) * 0.5), Bmat=f(b, k, L, n), Cmat=f(b, k, L, n),
                    D=f(k, d) if with_d else None, delta_bias=f(k, d) * 0.3 if with_d else None)

    worst, first = 0.0, None
    with torch.inference_mode(), true_float32():
        cases = [(label, b, k, L, d, n, with_d, operands(b, k, L, d, n, with_d))
                 for label, b, k, L, d, n, with_d in K4_CASES]
        _kernels.reset_launches()
        ys = [selective_scan_kernel(**case[-1]) for case in cases]
        torch.cuda.synchronize()
        launches = _kernels.LAUNCHES["selective_scan"]
        print(f"K4 entry point: {launches} launches over {len(cases)} calls", flush=True)
        if launches != len(cases):
            fail(f"K4's entry point launched {launches} times for {len(cases)} calls")
        for (label, b, k, L, d, n, with_d, ops), y in zip(cases, ys):
            want = []
            plain_ms = cuda_ms(lambda: want.append(selective_scan(**ops)), 1)
            max_err, ok = compare(y, want[0], SCAN_ATOL, SCAN_RTOL)
            if not torch.equal(y, selective_scan_kernel(**ops)):
                fail(f"K4 {label} does not repeat bit for bit")
            del want
            t_kern = cuda_ms(lambda: selective_scan_kernel(**ops), ITERS)
            b_ms, b_by = bound(*k4_work(b * k, L, d, n))
            print(f"K4 {label:20s} B={b} K={k} L={L} D={d} N={n} D,bias={'yes' if with_d else 'no'}"
                  f"  max|d|={max_err:.3e} ({'ok' if ok else 'MISS'})  kernel {t_kern:.3f} ms  "
                  f"plain {plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})", flush=True)
            if not ok:
                fail(f"K4 disagrees with its plain version at {label}")
            worst = max(worst, max_err)
            first = first or (t_kern, plain_ms, b_ms, b_by)
        del cases, ys
        torch.cuda.empty_cache()
    return launches, (worst,) + first


def phase_probe(device, scan_ms):
    """P1 against ``probe_plain`` at the JAX probe's shapes (x (8, 512, 128),
    rounds 32) for each op, within PROBE_RTOL and bit for bit on repeat;
    then the rate entry point (counts set to 0 just before, read just after),
    the GEMM rates and the two scan floors beside ``scan_ms`` ({kernel: (ms
    a call, its state updates, its exp2 a state update)}): 3 mul + 3 fma +
    1 exp a state update, and the MUFU floor (the kernel's exp2 a state
    update), each at the measured rates and scaled to the kernel's updates. Returns (launches,
    (max rel|d|, mean ms, mean plain ms, bound ms, bound by) over the three
    ops at rounds 32); the bound is the larger of the bytes over 3.35 TB/s
    and the mean over the ops of their operations at ``P1_OP_PER_S``."""
    import torch

    from tpuir_torch.ops import _kernels
    from tpuir_torch.utils import micro_rate

    x = torch.from_numpy(np.random.RandomState(SEED).rand(
        micro_rate.STREAMS, *micro_rate.BLOCK).astype(np.float32)).to(device)
    worst, rows = 0.0, []
    for op in micro_rate.OPS:
        got = micro_rate.probe(x, op)
        want = micro_rate.probe_plain(x, op)
        rel = ((got - want).abs() / want.abs()).max().item()
        ok = rel <= PROBE_RTOL and bool(torch.isfinite(got).all().item())
        if not torch.equal(got, micro_rate.probe(x, op)):
            fail(f"P1 {op} does not repeat bit for bit")
        t_kern = cuda_ms(lambda: micro_rate.probe(x, op), ITERS)
        t_plain = cuda_ms(lambda: micro_rate.probe_plain(x, op), 3)
        t_bytes = 1e3 * 4 * (x.numel() + x[0].numel()) / HBM_BYTES_PER_S
        t_ops = 1e3 * x.numel() * micro_rate.ROUNDS / P1_OP_PER_S[op]
        b_ms, b_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        print(f"P1 {op:4s} x (8, 512, 128) rounds {micro_rate.ROUNDS}  max rel|d|={rel:.3e} "
              f"(rtol {PROBE_RTOL:g}: {'ok' if ok else 'MISS'})  kernel {t_kern:.4f} ms  "
              f"plain {t_plain:.3f} ms  bound {b_ms:.5f} ms ({b_by})", flush=True)
        if not ok:
            fail(f"P1 {op} disagrees with its plain version")
        worst = max(worst, rel)
        rows.append((t_kern, t_plain, t_bytes, t_ops))

    _kernels.reset_launches()
    rates = micro_rate.elementwise_rates(device)
    launches = _kernels.LAUNCHES["rate_probe"]
    if not launches:
        fail("the rate entry point launched no probe")
    for op, rate in rates.items():
        print(f"P1 rate {op:4s} {rate:12.1f} Gelem/s (rounds {micro_rate.TIMED_ROUNDS})",
              flush=True)
    for name, tf in micro_rate.gemm_rates(device).items():
        print(f"torch.matmul {name} 8192^3 {tf:9.1f} TFLOP/s", flush=True)
    floor, mufu = micro_rate.scan_floor_ms(rates), micro_rate.mufu_floor_ms(rates)
    print(f"scan floor at MaIR-CDN@128, batch 8, d_inner 234 (3 mul + 3 fma + 1 exp a state "
          f"update at the measured rates): {floor:.4f} ms; three-pass MUFU floor (2 exp2 a "
          f"state update at the measured exp2 rate): {mufu:.4f} ms; "
          + ", ".join(f"{k} {ms:.3f} ms ({ms / micro_rate.scan_floor_ms(rates, n):.2f}x, "
                      f"{ms / micro_rate.mufu_floor_ms(rates, n, exps):.2f}x its MUFU floor "
                      f"of {exps} exp2 an update)"
                      for k, (ms, n, exps) in scan_ms.items()),
          flush=True)
    mean = lambda i: sum(r[i] for r in rows) / len(rows)  # noqa: E731
    return launches, (worst, mean(0), mean(1), max(mean(2), mean(3)),
                      "bytes" if mean(2) >= mean(3) else "operations")


def k1_serving_products(batch, hw, C):
    """The products of K1's serving body on the core's bf16-operand kernel as
    (label, images, M, N, K, one weight an image): the attention apply
    (blockdiag(A_b), one C x C weight an image), the projection and
    project_out (K the gate's row stride, h rounded up to 8). qkv and
    project_in run fused with their depthwise convs."""
    hp, px = -(-int(C * 2.66) // 8) * 8, batch * hw * hw
    return [("apply", batch, hw * hw, C, C, True), ("proj", 1, px, C, C, False),
            ("ffn_out", 1, px, C, hp, False)]


def k1_serving_work(batch, hw, C, heads, ln_bias=False):
    """(bytes, tensor-core operations, other operations) of one serving
    block: bf16 x in and out, float32 weights once; its products (the four
    1x1 products, the Gram and the attention apply at one head's width) at
    the bf16 tensor-core rate; the depthwise convs and the GELU gate at the
    float32 rate."""
    h, hc, px = int(C * 2.66), C // heads, batch * hw * hw
    weights = 3 * C * C + 27 * C + heads + C * C + 2 * h * C + 18 * h + h * C + 2 * C
    weights += 2 * C if ln_bias else 0
    nbytes = 2 * 2 * px * C + 4 * weights
    gemm = px * (2 * C * 3 * C + 4 * C * hc + 2 * C * C + 2 * C * 2 * h + 2 * h * C)
    return nbytes, gemm, px * (18 * 3 * C + 18 * 2 * h + 8 * h)


def bound_bf16(nbytes, gemm_flops, flops, exps=0):
    """(least ms, what bounds it) for work of nbytes whose gemm_flops run on
    the tensor cores in bf16 and the other flops at the float32 rate, or
    whose ``exps`` exponentials take the special-function lanes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(gemm_flops / BF16_FLOP_PER_S + flops / FP32_FLOP_PER_S, mufu_ms(exps) / 1e3)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gemm_bf16_yardstick(label, images, M, N, K, per_image, device, seed, core=True):
    """The GEMM core's bf16-operand kernel alone at one product shape
    (``ops/tc_gemm.gemm_bf16_operands``), held against float64 products of
    its bf16 operands, and beside ``torch.matmul`` on them in bf16 (a bf16
    output): prints max |error|, its share of atol + rtol * |ref| and
    TFLOP/s of each; fails if the core misses the tolerance. With ``core``
    False, ``torch.matmul`` alone: the library's time at a product shape
    that no standalone kernel of the port takes."""
    import torch

    from tpuir_torch.ops.tc_gemm import gemm_bf16_operands

    gen = torch.Generator(device=device).manual_seed(seed)
    a16 = torch.randn(images, M, K, device=device, generator=gen).to(torch.bfloat16)
    w16 = (torch.randn(*((images,) if per_image else ()), N, K, device=device,
                       generator=gen) * K ** -0.5).to(torch.bfloat16)
    tflop = 2 * images * M * N * K / 1e12
    with torch.inference_mode():
        mm = lambda: torch.matmul(a16, w16.transpose(-1, -2))  # noqa: E731
        kern = lambda: gemm_bf16_operands(a16, w16)  # noqa: E731
        ref = torch.matmul(a16.double(), w16.double().transpose(-1, -2))
        stats = []
        for fn in (kern, mm) if core else (mm,):
            err = (fn().double() - ref).abs()
            stats.append((err.max().item(), (err / (ATOL + RTOL * ref.abs())).max().item()))
            del err
        del ref
        mm()
        t_mm = cuda_ms(mm, ITERS)
        if not core:
            t_mm = (t_mm + cuda_ms(mm, ITERS)) / 2
            print(f"  torch.matmul bf16 {label:26s} {images}x({M}x{K} . {N}x{K}^T) "
                  f"{t_mm:.3f} ms {tflop / t_mm * 1e3:6.1f} TFLOP/s max|err| "
                  f"{stats[0][0]:.2e} (bf16 out; the library's yardstick, no kernel of the "
                  f"port's)", flush=True)
            return
        kern()
        t_core = (cuda_ms(kern, ITERS) + cuda_ms(kern, ITERS)) / 2
        t_mm = (t_mm + cuda_ms(mm, ITERS)) / 2
    print(f"  bf16-operand core {label:26s} {images}x({M}x{K} . {N}x{K}^T)  core {t_core:.3f} ms "
          f"{tflop / t_core * 1e3:6.1f} TFLOP/s max|err| {stats[0][0]:.2e} "
          f"({stats[0][1]:.3f} of tol)  torch.matmul bf16 {t_mm:.3f} ms "
          f"{tflop / t_mm * 1e3:6.1f} TFLOP/s max|err| {stats[1][0]:.2e} (bf16 out)", flush=True)
    if not stats[0][1] <= 1.0:
        fail(f"the bf16-operand core misses atol {ATOL:g} + rtol {RTOL:g} against float64 "
             f"products of its bf16 operands at {label}")


def ulp2_ratio(got, want) -> float:
    """max |got - want| in units of 2^-6 * max(|want|, 1), two bf16 ulps."""
    return ((got - want).abs() / (2.0 ** -6 * want.abs().clamp_min(1.0))).max().item()


def phase_serving_kernels(device, batch=BATCH, shapes=BLOCK_SHAPES, prebuilt=None):
    """K1's serving body stage by stage at each block shape, both LN
    variants, on bf16 inputs; bit for bit on repeat.

    End to end the body cannot be held to its plain version at these
    widths: a float32 sum that differs in its last bit from another order's
    flips a bf16 operand of the next product now and then, and the flips
    cascade. So each stage the kernel writes (``ops/fused_block.
    serving_stages``, its two parts on the check's own scratch) is held to
    its function of the kernel's own previous stage
    (``utils/serving_check.check_serving_stages``): the LayerNorm
    statistics, the Gram sums and the norms bit for bit against emulations
    of the kernel's float32 arithmetic, each product within 5e-5 + 1e-4
    |ref| of float64 sums of its bf16 operands, the bf16 output the
    rounding of a value within that of its float64 reference. The output
    against the plain version (max|d|, and tpuir's block criteria, two bf16
    ulps and 1/20 of the serving-parity gap) is printed beside, for the
    record. Before each shape, the bf16 core alone at the body's five
    product shapes (``gemm_bf16_yardstick``); after,
    the check's mutation controls (``mutant_controls("K1")``: 16 required
    faults). Returns (max |kernel -
    plain|, per-forward kernel ms, per-forward plain ms, bound ms, what
    bounds it), the per-forward figures summing each BiasFree shape's over
    its blocks.
    """
    import torch

    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.restormer import init_block_params
    from tpuir_torch.ops.fused_block import (
        fused_transformer_block,
        fused_transformer_block_plain,
        fused_transformer_block_serving_plain,
        serving_stages,
    )
    from tpuir_torch.utils.serving_check import check_serving_stages

    worst = 0.0
    fwd_ms = fwd_plain_ms = fwd_bytes = fwd_gemm = fwd_other = 0.0
    with torch.inference_mode(), true_float32():
        for name, hw, C, heads, count in shapes:
            for label, images, M, N, K, per_image in k1_serving_products(batch, hw, C):
                gemm_bf16_yardstick(f"K1s {name} {label}", images, M, N, K, per_image, device,
                                    SEED + K)
            for ln_bias in (False, True):
                p = {k: v.to(device) for k, v in
                     init_block_params(C, heads, ln_bias, SEED + C).items()}
                x = torch.from_numpy(
                    np.random.RandomState(SEED + hw).rand(batch, hw, hw, C).astype(np.float32)
                ).to(device).to(torch.bfloat16).permute(0, 3, 1, 2)
                kern = lambda: fused_transformer_block(  # noqa: E731
                    x, p, heads, ln_bias, serving=True)
                plain = lambda: fused_transformer_block_serving_plain(  # noqa: E731
                    x, p, heads, ln_bias)
                got, again = kern(), kern()
                torch.cuda.synchronize()
                repeat = torch.equal(got, again)
                stages = serving_stages(x, p, heads, ln_bias)
                # the two parts give the whole body's output (on a CPU tensor both are
                # plain versions, with different sum orders)
                parts = device.type != "cuda" or torch.equal(stages["out"], got)
                verdicts = check_serving_stages(x, p, heads, ln_bias, stages)
                del stages, again
                got, want = got.float(), plain().float()
                gap = (want - fused_transformer_block_plain(x.float(), p, heads, ln_bias)
                       ).abs().mean().item()
                max_err = (got - want).abs().max().item()
                tp_ratio, tp_mean = ulp2_ratio(got, want), (got - want).abs().mean().item() / gap
                del got, want
                t_kern, t_plain = timed_pair(kern, plain)
                nbytes, gemm, other = k1_serving_work(batch, hw, C, heads, ln_bias)
                b_ms, _ = bound_bf16(nbytes, gemm, other)
                missed = [v.name for v in verdicts if not v.ok]
                print(f"K1 serving {name:20s} B={batch} {hw}x{hw} C={C:3d} heads={heads} "
                      f"ln_bias={int(ln_bias)}  stages {'ok' if not missed else 'MISS'}; "
                      f"against plain max|d| {max_err:.3e} ({tp_ratio:.2f} x 2 ulps, mean "
                      f"{tp_mean:.3f} of the gap); repeat {'bit for bit' if repeat else 'DIFFERS'}"
                      f"; parts {'= whole' if parts else 'DIFFER'}  kernel {t_kern:.3f} ms  "
                      f"plain {t_plain:.3f} ms  bound {b_ms:.3f} ms"
                      + (f"  (the replaced body, recorded on an H100 at 700 W: "
                         f"{K1_SERVING_REPLACED_MS[name]:.3f} ms)" if not ln_bias else ""),
                      flush=True)
                for v in verdicts:
                    print(f"    {v.name:18s} {'ok  ' if v.ok else 'MISS'} {v.detail}", flush=True)
                if missed:
                    fail(f"K1 serving misses its stage checks at {name} ln_bias={ln_bias}: "
                         f"{', '.join(missed)}")
                if not repeat or not parts:
                    fail(f"K1 serving is not repeatable at {name} ln_bias={ln_bias}")
                worst = max(worst, max_err)
                if not ln_bias:
                    fwd_ms += count * t_kern
                    fwd_plain_ms += count * t_plain
                    fwd_bytes += count * nbytes
                    fwd_gemm += count * gemm
                    fwd_other += count * other
                del x, p
    torch.cuda.empty_cache()  # each copy's float64 check at level 1 holds several GB of the card
    mutant_controls("K1", jobs=4, prebuilt=prebuilt)
    return (worst, fwd_ms, fwd_plain_ms) + bound_bf16(fwd_bytes, fwd_gemm, fwd_other)


def phase_serving_path(device, parity_outs, requests=REQUESTS):
    """Serve Restormer through the zoo with ``precision="serving"`` on phase
    3's seeded weights and requests (host AWGN sigma 25), ROUNDS rounds: 44
    serving-body launches a chunk and no parity K1 launch, bit for bit on
    repeat, within SERVING_LSB of the same path with plain serving blocks,
    and within SERVING_PSNR_DB of phase 3's parity outputs ``parity_outs``
    ({(h, w): (output, ms)}) on every request; engine Mpix/s beside phase
    3's (``check_serving_path``). Returns {kernel: launches}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.restormer import Restormer, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "Restormer", "denoising", "gaussian_color_denoising_sigma25.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False,
                                       sigma=SIGMA, weights_dir=wdir, precision="serving",
                                       device=device)
    print(f"serving path: Restormer color sigma={SIGMA}, precision=serving, compute_dtype "
          f"{model.compute_dtype}, patch {model.patch_size} batch {model.batch_size}", flush=True)
    clean = [synthetic_image(h, w, SEED + i) for i, (h, w) in enumerate(requests)]
    return check_serving_path(
        "Restormer serving", model, plain_twin(model, Restormer(**CONFIG, fused=False,
                                                                serving=True)),
        clean, requests, lambda h, w: {"fused_transformer_block_serving": 44}, SIGMA,
        parity_outs)


def check_serving_path(label, model, plain, images, sizes, per_chunk, sigma, parity_outs,
                       refs=None, psnr_db=SERVING_PSNR_DB):
    """Serve ``images`` (of ``sizes``) through the serving ``model`` ROUNDS
    times (``serve_kernel_rounds``: launches against ``per_chunk``, bit for
    bit on repeat) and once through its plain twin ``plain``; with ``sigma``
    the engine adds host AWGN, with None the images are served as they are,
    scored against ``refs`` (default: the images). On every request the
    serving output must lie within SERVING_LSB of the plain twin's, and its
    PSNR within ``psnr_db`` of the parity outputs ``parity_outs`` ({(h,
    w): (output, ms)}); engine Mpix/s is printed beside parity's. Returns
    {kernel: launches}."""
    from tpuir_torch.core.metrics import calculate_metrics

    refs = refs or images
    launches, outs = serve_kernel_rounds(label, model, images, sizes, per_chunk, sigma, refs)
    plain_outs = serve(plain, images, sigma, refs)
    for (h, w), ref, (pred, ms), (ppred, _, _, _) in zip(sizes, refs, outs, plain_outs):
        psnr, ssim = calculate_metrics(pred, ref)
        par_pred, par_ms = parity_outs[(h, w)]
        par_psnr, par_ssim = calculate_metrics(par_pred, ref)
        diff = lsb(pred, ppred)
        print(f"{label} request {h}x{w}x3: PSNR {psnr:.4f} dB SSIM {ssim:.5f} "
              f"(parity {par_psnr:.4f} dB {par_ssim:.5f}, delta {psnr - par_psnr:+.4f} dB, "
              f"max|serving-parity| {lsb(pred, par_pred)} LSB)  serving {ms:.1f} ms "
              f"{h * w / 1e3 / ms:.3f} Mpix/s (parity {par_ms:.1f} ms)  max|kernel-plain| "
              f"{diff} LSB", flush=True)
        if diff > SERVING_LSB:
            fail(f"the {label} path and its plain twin differ by {diff} LSB on {h}x{w}")
        if abs(psnr - par_psnr) > psnr_db:
            fail(f"{label} PSNR {psnr:.4f} dB is {psnr - par_psnr:+.4f} dB from parity on "
                 f"{h}x{w}")
    mpix = sum(h * w for h, w in sizes) / 1e6
    rate = mpix / (sum(ms for _, ms in outs) / 1e3)
    par_rate = mpix / (sum(parity_outs[hw][1] for hw in sizes) / 1e3)
    print(f"{label} engine over the {len(sizes)} requests ({mpix:.4f} Mpix): serving "
          f"{rate:.3f} Mpix/s, parity {par_rate:.3f} Mpix/s", flush=True)
    return launches


def serving_prologue_work(px, dm, di):
    """K6 serving: (bytes, products, other operations): h float32 in, x and z
    bf16 out, float32 weights; in_proj at the bf16 rate, the depthwise conv,
    bias + SiLU at the float32 rate."""
    return (4 * px * dm + 2 * 2 * px * di + 4 * (2 * di * dm + 10 * di),
            px * 2 * dm * 2 * di, px * (18 * di + 5 * di))


def serving_scan_work(px, di, n, r):
    """K2 serving: (bytes, products, other operations, exponentials): bf16 x
    in and bf16 y out, the id table, float32 weights; x_proj and dt_proj at
    the bf16 rate, the rest of ``scan_work`` at the float32 rate, one exp2 a
    state update."""
    c = r + 2 * n
    nbytes = 2 * px * di + 4 * 4 * px + 2 * 4 * px * di + 4 * 4 * (c * di + di * r + di * n
                                                                    + 2 * di)
    return (nbytes, 4 * px * (2 * c * di + 2 * r * di), 4 * px * (8 * di + 7 * di * n),
            4 * px * di * n)


def serving_epilogue_work(px, di, dm, images):
    """K7 serving: (bytes, products, other operations): four bf16 direction
    images and bf16 z in, float32 gates and weights, float32 out; out_proj at
    the bf16 rate, the gated sum, LayerNorm and SiLU gate at the float32
    rate."""
    return (2 * (4 * px * di + px * di) + 4 * (4 * images * di + 2 * di + dm * di + px * dm),
            px * 2 * di * dm, px * (8 * di + 8 * di + 6 * di))


def mixer_serving_bodies(pro, scan, epi, px, images, shifts=(False, True)):
    """The serving bodies of K6, K2 (at each of ``shifts``) and K7 on the
    operands ``mixer_operands`` makes (bf16 where a body takes bf16), for
    ``check_serving_body``: (kernel name, short label, shift, stages, their
    check, kernel, plain, the kernel's outputs among its stages, iterations
    timed, plain's, work) each, ``px`` pixels over ``images`` images."""
    import torch

    from tpuir_torch.ops.nss_epilogue import (mixer_epilogue, mixer_epilogue_serving_plain,
                                              mixer_epilogue_serving_stages)
    from tpuir_torch.ops.nss_prologue import (mixer_prologue, mixer_prologue_serving_plain,
                                              mixer_prologue_serving_stages)
    from tpuir_torch.ops.nss_stripe import (nss_scan, nss_scan_serving_plain,
                                            nss_scan_serving_stages)
    from tpuir_torch.utils import serving_check as ck

    bf = torch.bfloat16
    x = scan["x"].to(bf)
    sw = {k: v for k, v in scan.items() if k != "x"}
    y, z = epi["y"].to(bf), epi["z"].to(bf)
    ew = {k: v for k, v in epi.items() if k not in ("y", "z")}
    dm, di = pro[1].shape[1], pro[1].shape[0] // 2
    n, r = sw["A"].shape[-1], sw["dt_w"].shape[-1]
    bodies = [("mixer_prologue_serving", "K6s", None,
               lambda: mixer_prologue_serving_stages(*pro),
               lambda st: ck.check_prologue_serving(*pro, st),
               lambda: mixer_prologue(*pro, serving=True),
               lambda: mixer_prologue_serving_plain(*pro),
               lambda st: (st["x"], st["z"]), ITERS, ITERS, serving_prologue_work(px, dm, di))]
    for shift in shifts:
        bodies.append((
            "nss_scan_serving", "K2s", shift,
            lambda shift=shift: nss_scan_serving_stages(x, **sw, shift=shift),
            lambda st, shift=shift: ck.check_scan_serving(x, **sw, scan_len=4, shift=shift,
                                                          st=st),
            lambda shift=shift: nss_scan(x, **sw, shift=shift, serving=True),
            lambda shift=shift: nss_scan_serving_plain(x, **sw, shift=shift),
            lambda st: (st["y"], st["pooled"]), 3, 1, serving_scan_work(px, di, n, r)))
    bodies.append(("mixer_epilogue_serving", "K7s", None,
                   lambda: mixer_epilogue_serving_stages(y, z=z, **ew),
                   lambda st: ck.check_epilogue_serving(y, z=z, **ew, st=st),
                   lambda: mixer_epilogue(y, z=z, **ew, serving=True),
                   lambda: mixer_epilogue_serving_plain(y, z=z, **ew),
                   lambda st: st["out"], ITERS, ITERS, serving_epilogue_work(px, di, dm, images)))
    return bodies


def check_serving_body(label, stages, check, kern, plain, outs, work, iters=ITERS,
                       plain_iters=ITERS, timing="turns", replaced=None):
    """One serving body held stage by stage: its stage entry ``stages()``
    twice, bit for bit, the wrapper ``kern()``'s output the stages' ``outs``,
    each stage within ``check`` (``utils/serving_check.py``); its output
    against ``plain()`` (max|d|, and tpuir's criterion of two bf16 ulps)
    printed for the record. ``timing``: "turns" (CUDA events, plain,
    kernel, kernel, plain), "once" (the plain version timed once, the
    kernel over ``iters``) or None; ``replaced``: the recorded ms of the body
    this one replaced, printed beside as such. Prints one line and the
    stages, fails on a miss. Returns (max |kernel - plain|, ms, plain ms,
    bound ms, bound by) from ``work``'s ``bound_bf16``."""
    import torch

    st = {k: v.clone() for k, v in stages().items()}
    again = stages()
    got = kern()
    torch.cuda.synchronize()
    repeat = all(torch.equal(st[k], again[k]) for k in st) and all(
        torch.equal(g, s) for g, s in zip(as_tuple(got), as_tuple(outs(st))))
    del again
    verdicts = check(st)
    del st
    want = []
    t_plain = cuda_ms(lambda: want.append(plain()), 1)
    max_err, ulps = 0.0, 0.0
    for g, w in zip(as_tuple(got), as_tuple(want[0])):
        max_err = max(max_err, (g.float() - w.float()).abs().max().item())
        if g.dtype == torch.bfloat16:
            ulps = max(ulps, ulp2_ratio(g.float(), w.float()))
    del got, want
    t_kern = None
    if timing == "turns":
        t_kern, t_plain = timed_pair(kern, plain, iters, plain_iters)
    elif timing == "once":
        t_kern = cuda_ms(kern, iters)
    else:
        t_plain = None
    b_ms, b_by = bound_bf16(*work)
    missed = [v.name for v in verdicts if not v.ok]
    times = (f"kernel {t_kern:.3f} ms  plain {t_plain:.3f} ms  bound {b_ms:.3f} ms ({b_by})"
             if timing else "(not timed)")
    if timing and replaced is not None:
        times += f"  (the replaced body, recorded on an H100 at 700 W: {replaced:.3f} ms)"
    print(f"{label:30s} stages {'ok' if not missed else 'MISS'}; against plain max|d| "
          f"{max_err:.3e}" + (f" ({ulps:.2f} x 2 bf16 ulps)" if ulps else "")
          + f"; repeat {'bit for bit' if repeat else 'DIFFERS'}  {times}", flush=True)
    for v in verdicts:
        print(f"    {v.name:16s} {'ok  ' if v.ok else 'MISS'} {v.detail}", flush=True)
    if missed:
        fail(f"{label} misses its stage checks: {', '.join(missed)}")
    if not repeat:
        fail(f"{label} is not repeatable")
    return max_err, t_kern, t_plain, b_ms, b_by


def phase_mair_serving_kernels(device, batch=BATCH, tile=MAIR_TILE, rect=(96, 72)):
    """The serving bodies of K6, K2 and K7 stage by stage, timed (their
    mutation controls run after phase 20, ``DEFERRED_MUTANTS``).

    At MaIR-CDN@``tile``, batch ``batch`` (timed: plain, kernel, kernel,
    plain), and at the ``rect`` tile, batch 1, on phase 4's seeded
    activations (the plain parity mixer's, rounded to bf16 where a body
    takes bf16): each body's stages (``ops/*.mixer_*_serving_stages``,
    ``nss_scan_serving_stages``) twice, bit for bit, the wrapper's output
    the same, each stage held to its float64 function of the kernel's own
    previous stage (``utils/serving_check.py``); the output against the
    plain version (max|d|, and tpuir's criterion of two bf16 ulps) printed
    for the record; K6's, K2's and K7's times beside those of the bodies they
    replaced (``SERVING_REPLACED_MS``). Before, the bf16-operand core alone
    at K7's out_proj shape (K padded to 8) and ``torch.matmul`` bf16 at
    K6's in_proj shape (``gemm_bf16_yardstick``); after,
    ``utils/serving_mutants.run_mutants("mixer")``. Returns {kernel: (max
    |kernel - plain|, ms, plain ms, bound ms, bound by)} per call at
    ``tile``, K2 the mean over both shifts."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops.nss_epilogue import padded_inner

    cfg = zoo.MAIR_CDN_CONFIG
    dm = cfg["embed_dim"]
    di = int(cfg["ssm_ratio"] * dm)
    res = {}
    with torch.inference_mode(), true_float32():
        px = batch * tile * tile
        gemm_bf16_yardstick(f"K6s MaIR-CDN@{tile} in_proj", 1, px, 2 * di, dm, False, device,
                            SEED, core=False)
        gemm_bf16_yardstick(f"K7s MaIR-CDN@{tile} out_proj", 1, px, dm,
                            padded_inner(di, serving=True), False, device, SEED)
        for b, hw, timed in ((batch, (tile, tile), True), (1, rect, False)):
            pro, scan, epi = mixer_inputs(device, b, hw)
            px = b * hw[0] * hw[1]
            for (name, short, shift, stages, check, kern, plain, outs, iters, plain_iters,
                 work) in mixer_serving_bodies(pro, scan, epi, px, b):
                label = (f"{short} B={b} {hw[0]}x{hw[1]}"
                         + (f" shift={int(shift)}" if shift is not None else ""))
                replaced = SERVING_REPLACED_MS.get(short, {}).get(f"MaIR-CDN@{tile}")
                row = check_serving_body(label, stages, check, kern, plain, outs, work, iters,
                                         plain_iters, "turns" if timed else None, replaced)
                prev = res.get(name)
                if timed:
                    if prev and prev[1] is not None:  # K2: the mean over both shifts
                        row = (max(prev[0], row[0]), (prev[1] + row[1]) / 2,
                               (prev[2] + row[2]) / 2) + row[3:]
                else:
                    row = (max(prev[0], row[0]),) + prev[1:]
                res[name] = row
            del pro, scan, epi
            torch.cuda.empty_cache()
    return res


def mutant_controls(bodies, jobs, prebuilt=None):
    """``utils/serving_mutants.run_mutants(bodies)``: each fault in its own
    copy of ``tpuir_torch/``, built there from this tree's objects (only
    the sources the fault reaches are recompiled; with ``prebuilt``, a
    ``serving_mutants.Prebuilt``, built ahead while the card ran the earlier
    phases), ``jobs`` copies checked at once; fails if the check accepts a
    required mutant or rejects the unmutated copy."""
    import torch

    from tpuir_torch.utils.serving_mutants import failures, run_mutants

    torch.cuda.empty_cache()  # the workers check their copies on this card beside us
    t0 = time.time()
    if prebuilt is not None:
        print(f"{bodies} serving mutants: planted copies {prebuilt.summary()}", flush=True)
    verdicts = run_mutants(bodies, jobs=jobs, prebuilt=prebuilt)
    bad = failures(bodies, verdicts)
    print(f"{bodies} serving mutants ({time.time() - t0:.0f} s): "
          + (f"FAILED {bad}" if bad else "every required mutant rejected, the unmutated "
             "copy accepted"), flush=True)
    if bad:
        fail(f"the {bodies} serving check's mutation controls failed: {bad}")


def phase_mair_serving_path(device, parity_outs, requests=MAIR_REQUESTS):
    """Serve MaIR-CDN through the zoo with ``precision="serving"`` on phase
    5's seeded weights and requests (host AWGN sigma 25), ROUNDS rounds: 36
    launches a chunk of each serving body and none of the parity K6, K2 and
    K7, bit for bit on repeat, within SERVING_LSB of the same path with
    plain serving mixers, and within SERVING_PSNR_DB of phase 5's parity
    outputs ``parity_outs`` ({(h, w): (output, ms)}) on every request;
    engine Mpix/s beside phase 5's (``check_serving_path``). Returns
    {kernel: launches}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair import MaIR, init_state_dict

    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        path = os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{SIGMA}.pth")
        os.makedirs(os.path.dirname(path))
        torch.save({"params": init_state_dict(zoo.MAIR_CDN_CONFIG, seed=SEED)}, path)
        model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                       weights_dir=wdir, precision="serving", device=device)
    print(f"serving path: MaIR-CDN sigma={SIGMA}, precision=serving, compute_dtype "
          f"{model.compute_dtype}, patch {model.patch_size} batch {model.batch_size}", flush=True)
    clean = [synthetic_image(h, w, SEED + i) for i, (h, w) in enumerate(requests)]
    return check_serving_path(
        "MaIR-CDN serving", model,
        plain_twin(model, MaIR(**zoo.MAIR_CDN_CONFIG, fused=False, serving=True)), clean,
        requests, lambda h, w: dict.fromkeys(MIXER_SERVING, MAIR_BLOCKS), SIGMA, parity_outs)


def serving_k3_work(seqs, L, di, n, r):
    """K3 serving: (bytes, products, other operations, exponentials): bf16 xs
    in, float32 y out, float32 weights; x_proj and dt_proj at the bf16
    rate, the rest of ``k3_work`` at the float32 rate, one exp2 a state
    update."""
    c, pos = r + 2 * n, seqs * L
    nbytes = 2 * pos * di + 4 * pos * di + 4 * 4 * (c * di + di * r + di * n + 2 * di)
    return (nbytes, pos * (2 * c * di + 2 * r * di), pos * (4 * di + 7 * di * n + 2 * di),
            pos * di * n)


def serving_k5_work(px, di, n, r):
    """K5 serving: ``serving_scan_work`` less the id table, which K5 does not read."""
    nbytes, gemm, other, exps = serving_scan_work(px, di, n, r)
    return nbytes - 4 * 4 * px, gemm, other, exps


def phase_seq_serving_kernels(device, levels=UNET_LEVELS, rect=UNET_RECT,
                              k3_levels=UNET_K3_LEVELS, tile=MAIR_TILE, cdn_batch=BATCH):
    """Phase 14's kernels: the serving bodies at MaIRUNet's widths and K3's
    and K5's serving bodies, each stage by stage (``check_serving_body``),
    bit for bit on repeat, timed beside its plain version (their mutation
    controls, ``utils/serving_mutants.py --bodies seq``, run after phase
    20).

    K6, K2 and K7 serving at MaIRUNet's five level shapes of a 384x384 tile
    (batch 8) and K2 serving at the 384x328 tile (batch 2), on phase 6's
    seeded weights and activations (bf16 where a body takes bf16), the plain
    version timed once; K3 serving at the 481x321 request's two K3 levels
    (batch 2), its plain version timed once; K5 serving at MaIR-CDN@128
    (batch 8, shift off and on, timed in turns), the 96x72 tile (batch 1,
    not timed) and the 384x328 tile (batch 2, MaIRUNet's level-0 weights,
    the plain version timed once). Returns ({kernel: (max |kernel - plain|,
    ms, plain ms, bound ms, bound by)} of K3 serving per forward chunk of
    the 481x321 request and K5 serving per call at MaIR-CDN@128 (the mean
    over both shifts), {kernel: max |kernel - plain|} of K6, K2 and K7
    serving here)."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.mair_unet import init_state_dict
    from tpuir_torch.ops.nss_fused import (nss_scan_fused, nss_scan_fused_serving_plain,
                                           nss_scan_fused_serving_stages)
    from tpuir_torch.ops.scan_fused_proj import (selective_scan_fused_proj,
                                                 selective_scan_fused_proj_serving_plain,
                                                 selective_scan_fused_proj_serving_stages)
    from tpuir_torch.ops.scan_ids import scan_index_tensors
    from tpuir_torch.utils import serving_check as ck

    bf = torch.bfloat16
    sd = init_state_dict(zoo.MAIR_UNET_CONFIG, seed=SEED)
    worst, rows = {}, {}
    fwd = {}  # per MaIRUNet@384 forward: [ms, plain ms, bytes, products, other, exps]

    def keep(name, row):
        worst[name] = max(worst.get(name, 0.0), row[0])

    with torch.inference_mode(), true_float32():
        cases = [(label, t, t, stage, BATCH, count) for label, t, stage, count in levels]
        cases.append(("rect", rect[0], rect[1], rect[2], 2, 0))
        for label, hh, ww, stage, b, count in cases:
            w, dm, di, n = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            pro, scan, epi, _, _ = mixer_operands(w, b, (hh, ww), SEED)
            for (name, short, _, stages, check, kern, plain, outs, iters, _,
                 work) in mixer_serving_bodies(pro, scan, epi, b * hh * ww, b, (False,)):
                if label == "rect" and name != "nss_scan_serving":
                    continue  # the rectangular tile is K2a's case
                row = check_serving_body(f"{short} B={b} {hh}x{ww} Di={di} N={n}", stages,
                                         check, kern, plain, outs, work, 3, timing="once",
                                         replaced=SERVING_REPLACED_MS.get(short, {}).get(label))
                keep(name, row)
                acc = fwd.setdefault(short, [0.0] * 6)
                for i, v in enumerate(row[1:3] + work):
                    acc[i] += count * v
            del pro, scan, epi
            torch.cuda.empty_cache()
        for short, (ms, plain_ms, *work) in fwd.items():
            b_ms, b_by = bound_bf16(*work)
            was = SERVING_REPLACED_MS.get(short, {}).get("forward")
            print(f"{short} per MaIRUNet@384 forward (batch {BATCH}, "
                  f"{sum(c for *_, c in levels)} calls): kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})"
                  + (f" (the replaced body, recorded on an H100 at 700 W: {was:.2f} ms)"
                     if was else ""), flush=True)

        # K3 serving at the 481x321 request's two K3 levels, per forward chunk
        k3 = [0.0] * 6
        for label, hh, ww, stage, count in k3_levels:
            w, dm, di, n = mixer_weights(sd, f"{stage}.0.self_attention.", device)
            r = w["dt_projs_weight"].shape[-1]
            _, scan, _, _, _ = mixer_operands(w, 2, (hh, ww), SEED)
            ids, _ = scan_index_tensors(hh, ww, 4, 0, device)
            L = hh * ww
            xs = scan.pop("x").reshape(2, L, di)[:, ids].to(bf)
            work = serving_k3_work(2 * 4, L, di, n, r)
            row = check_serving_body(
                f"K3s B=2 {hh}x{ww} Di={di} N={n}",
                lambda: selective_scan_fused_proj_serving_stages(xs, **scan),
                lambda st: ck.check_seq_scan_serving(xs, **scan, st=st),
                lambda: selective_scan_fused_proj(xs, **scan, serving=True),
                lambda: selective_scan_fused_proj_serving_plain(xs, **scan),
                lambda st: st["y"], work, 10, timing="once")
            keep("selective_scan_fused_proj_serving", row)
            for i, v in enumerate(row[1:3] + work):
                k3[i] += count * v
            del scan, xs
        k3_row = ((worst["selective_scan_fused_proj_serving"], k3[0], k3[1])
                  + bound_bf16(*k3[2:]))
        print(f"K3 serving per forward chunk of the 481x321 request (12 calls at 96x82, 8 at "
              f"48x41, batch 2): kernel {k3[0]:.3f} ms, plain {k3[1]:.3f} ms, bound "
              f"{k3_row[3]:.3f} ms ({k3_row[4]})", flush=True)

        # K5 serving: MaIR-CDN@128 (timed in turns), 96x72, and the 384x328 tile
        cdn = []
        unet_w = mixer_weights(sd, f"{rect[2]}.0.self_attention.", device)[0]
        k5_cases = [(cdn_batch, (tile, tile), None, (False, True), "turns", f"MaIR-CDN@{tile}"),
                    (1, (96, 72), None, (False, True), None, None),
                    (2, rect[:2], unet_w, (False,), "once", "rect")]
        for b, (hh, ww), w, shifts, timing, key in k5_cases:
            scan = (mixer_inputs(device, b, (hh, ww))[1] if w is None
                    else scan_operands(w, b, (hh, ww), SEED))
            x = scan.pop("x").to(bf)
            di, n, r = x.shape[-1], scan["A"].shape[-1], scan["dt_w"].shape[-1]
            for shift in shifts:
                row = check_serving_body(
                    f"K5s B={b} {hh}x{ww} Di={di} N={n} shift={int(shift)}",
                    lambda: nss_scan_fused_serving_stages(x, **scan, shift=shift),
                    lambda st: ck.check_fused_scan_serving(x, **scan, scan_len=4, shift=shift,
                                                           st=st),
                    lambda: nss_scan_fused(x, **scan, shift=shift, serving=True),
                    lambda: nss_scan_fused_serving_plain(x, **scan, shift=shift),
                    lambda st: (st["y01"], st["y23"], st["pooled"]),
                    serving_k5_work(b * hh * ww, di, n, r), 3, 1, timing,
                    replaced=K5S_REPLACED_MS.get(key))
                keep("nss_scan_fused_serving", row)
                if hh == tile and ww == tile:
                    cdn.append(row)
            del scan, x
            torch.cuda.empty_cache()
    mean = lambda i: sum(c[i] for c in cdn) / len(cdn)  # noqa: E731
    rows["nss_scan_fused_serving"] = (worst.pop("nss_scan_fused_serving"), mean(1), mean(2),
                                      cdn[0][3], cdn[0][4])
    rows["selective_scan_fused_proj_serving"] = k3_row
    worst.pop("selective_scan_fused_proj_serving")
    return rows, worst


def phase_seq_serving_path(device, unet_outs, mair_outs, unet_requests=UNET_REQUESTS,
                           mair_requests=MAIR_REQUESTS, seq_request=MAIR_REQUESTS[-1]):
    """Phase 14's paths, built through the zoo with ``precision="serving"``
    on the seeded weights of phases 5 and 7, each checked by
    ``check_serving_path`` (ROUNDS rounds, launches a chunk by route, bit
    for bit on repeat, within SERVING_LSB of its plain serving twin,
    PSNR within SERVING_PSNR_DB of parity, engine Mpix/s beside parity's):
    MaIRUNet on phase 7's noisy ``unet_requests`` against phase 7's parity
    outputs ``unet_outs``; MaIR-CDN with ``nss="fused"`` on phase 5's
    ``mair_requests`` and MaIRUNet with ``nss="fused"`` on the 481x321
    request; MaIR-CDN with ``nss="0"`` on ``seq_request`` only (each mixer
    on K3), against phase 5's ``mair_outs``. Returns {kernel: launches}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.models.mair import MaIR
    from tpuir_torch.models.mair import init_state_dict as mair_state_dict
    from tpuir_torch.models.mair_unet import MaIRUNet
    from tpuir_torch.models.mair_unet import init_state_dict as unet_state_dict

    sizes = UNET_KERNEL_ONLY + UNET_REQUESTS  # phase 7's images, by index
    unet_images = {}
    for hw in set(unet_requests) | {UNET_FUSED_REQUEST}:
        i = sizes.index(hw)
        clean = synthetic_image(*hw, SEED + i)
        unet_images[hw] = (noisy_image(clean, SEED + 100 + i), clean)
    mair_clean = {hw: synthetic_image(*hw, SEED + i) for i, hw in enumerate(MAIR_REQUESTS)}
    cfg_unet, cfg_cdn = zoo.MAIR_UNET_CONFIG, zoo.MAIR_CDN_CONFIG
    # (label, MaIRUNet or not, nss, the K5 or K3 kernel of MaIR-CDN's every mixer, requests)
    runs = [("MaIRUNet serving", True, "stripe", None, unet_requests),
            ("MaIR-CDN fused serving", False, "fused", "nss_scan_fused_serving", mair_requests),
            ("MaIRUNet fused serving", True, "fused", None, [UNET_FUSED_REQUEST]),
            ("MaIR-CDN nss=0 serving", False, "0", "selective_scan_fused_proj_serving",
             [seq_request])]
    launches = {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        os.makedirs(os.path.join(wdir, "MaIR", "denoising"))
        torch.save({"params": mair_state_dict(cfg_cdn, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{SIGMA}.pth"))
        torch.save({"params": unet_state_dict(cfg_unet, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", "MaIR_RealDN.pth"))
        for label, unet, nss, kernel, reqs in runs:
            if unet:
                model = zoo.get_model_instance("denoising", "real", "MaIR", weights_dir=wdir,
                                               precision="serving", device=device, nss=nss)
                plain = MaIRUNet(**cfg_unet, fused=False, nss=nss, serving=True)
                per_chunk = unet_per_chunk(model, fused=nss == "fused", serving=True)
                images = [unet_images[hw][0] for hw in reqs]
                refs, sigma, parity = [unet_images[hw][1] for hw in reqs], None, unet_outs
            else:
                model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=SIGMA,
                                               weights_dir=wdir, precision="serving",
                                               device=device, nss=nss)
                plain = MaIR(**cfg_cdn, fused=False, nss=nss, serving=True)
                per_chunk = lambda h, w, k=kernel: {k: MAIR_BLOCKS}  # noqa: E731
                images = refs = [mair_clean[hw] for hw in reqs]
                sigma, parity = SIGMA, mair_outs
            print(f"{label}: nss={nss}, compute_dtype {model.compute_dtype}, patch "
                  f"{model.patch_size} batch {model.batch_size}; per chunk "
                  + ", ".join(f"{h}x{w}: {chunks_for(model, h, w)} x {per_chunk(h, w)}"
                              for h, w in reqs), flush=True)
            got = check_serving_path(label, model, plain_twin(model, plain), images, reqs,
                                     per_chunk, sigma, parity, refs)
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            del model, plain
            torch.cuda.empty_cache()
    return launches


def phase_recur_kernels(device, batch=BATCH, tile=MAIR_TILE, rect=(96, 72)):
    """K2's bf16-recurrence body stage by stage (``check_serving_body`` with
    ``check_nss_scan_recur_serving``) at MaIR-CDN@``tile``, batch ``batch``,
    shift off and on (timed: plain, kernel, kernel, plain), and at the
    ``rect`` tile, batch 1, shift on, on phase 4's seeded activations
    rounded to bf16 (its mutation controls run after phase 20). Returns
    (max |kernel - plain|, ms, plain ms, bound ms, bound by) per call at
    ``tile``, the mean over both shifts."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops.nss_stripe import nss_scan, nss_scan_recur_plain, nss_scan_recur_stages
    from tpuir_torch.utils import serving_check as ck

    cfg = zoo.MAIR_CDN_CONFIG
    di = int(cfg["ssm_ratio"] * cfg["embed_dim"])
    rows = []
    with torch.inference_mode(), true_float32():
        for b, hw, shifts, timed in ((batch, (tile, tile), (False, True), True),
                                     (1, rect, (True,), False)):
            _, scan, _ = mixer_inputs(device, b, hw)
            x = scan.pop("x").to(torch.bfloat16)
            n, r = scan["A"].shape[-1], scan["dt_w"].shape[-1]
            for shift in shifts:
                rows.append(check_serving_body(
                    f"K2r B={b} {hw[0]}x{hw[1]} shift={int(shift)}",
                    lambda: nss_scan_recur_stages(x, **scan, shift=shift),
                    lambda st: ck.check_nss_scan_recur_serving(x, **scan, scan_len=4,
                                                               shift=shift, st=st),
                    lambda: nss_scan(x, **scan, shift=shift, serving=True, recur_bf16=True),
                    lambda: nss_scan_recur_plain(x, **scan, shift=shift),
                    lambda st: (st["y"], st["pooled"]),
                    serving_scan_work(b * hw[0] * hw[1], di, n, r), 3, 1,
                    "turns" if timed else None))
            del x, scan
            torch.cuda.empty_cache()
    timed_rows = rows[:2]
    return (max(row[0] for row in rows), sum(row[1] for row in timed_rows) / 2,
            sum(row[2] for row in timed_rows) / 2, timed_rows[0][3], timed_rows[0][4])


def recur_per_chunk(per_chunk):
    """A serving path's {kernel: launches a chunk} with K2's recur body in
    place of K2's serving body, which must not launch."""
    def recur(h, w):
        out = dict(per_chunk(h, w))
        out["nss_scan_recur_serving"] = out.pop("nss_scan_serving")
        out["nss_scan_serving"] = 0
        return out

    return recur


def phase_recur_path(device):
    """MaIR-CDN sigma=15 and the real-denoising MaIRUNet built through the zoo
    in parity, serving and serving with ``recur_bf16=True`` on the seeded
    weights of phases 5 and 7: each request served once in parity and in
    serving, then the recur path checked by ``check_serving_path`` against
    parity and its plain twin (``MaIR(fused=False, serving=True,
    recur_bf16=True)``); per request PSNR(recur) - PSNR(serving) and the
    recur path's Mpix/s beside serving's are printed. Returns {kernel:
    launches} of the recur paths."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.metrics import calculate_metrics
    from tpuir_torch.models.mair import MaIR
    from tpuir_torch.models.mair import init_state_dict as mair_state_dict
    from tpuir_torch.models.mair_unet import MaIRUNet
    from tpuir_torch.models.mair_unet import init_state_dict as unet_state_dict

    cfg_cdn, cfg_unet = zoo.MAIR_CDN_CONFIG, zoo.MAIR_UNET_CONFIG
    sizes = UNET_KERNEL_ONLY + UNET_REQUESTS  # phase 7's images, by index
    unet = {}
    for hw in RECUR_UNET_REQUESTS:
        i = sizes.index(hw)
        clean = synthetic_image(*hw, SEED + i)
        unet[hw] = (noisy_image(clean, SEED + 100 + i), clean)
    cdn = {hw: synthetic_image(*hw, SEED + i) for i, hw in enumerate(RECUR_MAIR_REQUESTS)}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_smoke_") as wdir:
        os.makedirs(os.path.join(wdir, "MaIR", "denoising"))
        torch.save({"params": mair_state_dict(cfg_cdn, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", f"MaIR_CDN_s{RECUR_SIGMA}.pth"))
        torch.save({"params": unet_state_dict(cfg_unet, seed=SEED)},
                   os.path.join(wdir, "MaIR", "denoising", "MaIR_RealDN.pth"))
        for label, is_unet in (("MaIR-CDN recur", False), ("MaIRUNet recur", True)):
            subtask, sigma = ("real", None) if is_unet else ("gaussian", RECUR_SIGMA)
            reqs = RECUR_UNET_REQUESTS if is_unet else RECUR_MAIR_REQUESTS
            images = [unet[hw][0] for hw in reqs] if is_unet else [cdn[hw] for hw in reqs]
            refs = [unet[hw][1] for hw in reqs] if is_unet else images

            def build(precision, recur=None):
                return zoo.get_model_instance("denoising", subtask, "MaIR", sigma=sigma,
                                              weights_dir=wdir, precision=precision,
                                              device=device, recur_bf16=recur)

            outs = {}
            for mode in ("parity", "serving"):
                model = build(mode, False)
                serve(model, images[-1:], sigma, refs[-1:])  # warm-up
                outs[mode] = {hw: (pred, ms) for hw, (pred, ms, _, _) in
                              zip(reqs, serve(model, images, sigma, refs))}
                del model
            model = build("serving", True)
            net = (MaIRUNet(**cfg_unet, fused=False, serving=True, recur_bf16=True) if is_unet
                   else MaIR(**cfg_cdn, fused=False, serving=True, recur_bf16=True))
            per_chunk = (unet_per_chunk(model, serving=True) if is_unet else
                         lambda h, w: dict.fromkeys(MIXER_SERVING, MAIR_BLOCKS))
            print(f"{label}: recur_bf16 on, patch {model.patch_size} batch {model.batch_size}; "
                  "per chunk " + ", ".join(f"{h}x{w}: {chunks_for(model, h, w)} x "
                                           f"{recur_per_chunk(per_chunk)(h, w)}"
                                           for h, w in reqs), flush=True)
            got = check_serving_path(label, model, plain_twin(model, net), images, reqs,
                                     recur_per_chunk(per_chunk), sigma, outs["parity"], refs,
                                     RECUR_PSNR_DB)
            rec = {hw: (pred, ms) for hw, (pred, ms, _, _) in
                   zip(reqs, serve(model, images, sigma, refs))}
            for hw, ref in zip(reqs, refs):
                p_rec = calculate_metrics(rec[hw][0], ref)[0]
                p_srv, p_par = (calculate_metrics(outs[m][hw][0], ref)[0]
                                for m in ("serving", "parity"))
                px = hw[0] * hw[1] / 1e3
                print(f"{label} request {hw[0]}x{hw[1]}x3: PSNR(recur) - PSNR(serving) "
                      f"{p_rec - p_srv:+.4f} dB, PSNR(recur) - PSNR(parity) "
                      f"{p_rec - p_par:+.4f} dB, max|recur-serving| "
                      f"{lsb(rec[hw][0], outs['serving'][hw][0])} LSB; engine recur "
                      f"{px / rec[hw][1]:.3f} Mpix/s, serving {px / outs['serving'][hw][1]:.3f} "
                      f"Mpix/s", flush=True)
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            del model, net
            torch.cuda.empty_cache()
    return launches


def plain_harness(**kw):
    """``tpuir_torch.harness.Harness(**kw)`` serving the plain twins of the
    zoo's models (Restormer's plain blocks, MaIR's plain mixers in the same
    precision and recurrence)."""
    from tpuir_torch import harness, zoo
    from tpuir_torch.models.mair import MaIR
    from tpuir_torch.models.restormer import Restormer

    class Plain(harness.Harness):
        def _model(self, task, subtask, model_name, gray, sigma):
            model = super()._model(task, subtask, model_name, gray, sigma)
            if model.name == "Restormer":
                net = Restormer(**CONFIG, fused=False, serving=model.compute_dtype is not None)
            else:
                mixer = next(m for m in model.net.modules() if hasattr(m, "recur_bf16"))
                net = MaIR(**zoo.MAIR_CDN_CONFIG, fused=False, serving=mixer.serving,
                           recur_bf16=mixer.recur_bf16)
            twin = plain_twin(model, net)
            twin.name, twin.param_count = model.name, model.param_count
            return twin

    return Plain(**kw)


def phase_harness(device):
    """The port's evaluation harness on the card (see phase 16 in the module
    docstring). Returns {kernel: launches}."""
    import torch

    from tpuir_torch import harness
    from tpuir_torch.core.image_io import imwrite_uint
    from tpuir_torch.models.mair import init_state_dict as mair_state_dict
    from tpuir_torch.models.restormer import init_state_dict as restormer_state_dict
    from tpuir_torch.ops import _kernels

    per_chunk = {
        ("parity", False): {"fused_transformer_block": 44, "mixer_prologue": 36,
                            "nss_scan": 36, "mixer_epilogue": 36},
        ("serving", False): {"fused_transformer_block_serving": 44,
                             **dict.fromkeys(MIXER_SERVING, MAIR_BLOCKS)},
        ("serving", True): {"fused_transformer_block_serving": 44,
                            "mixer_prologue_serving": 36, "nss_scan_recur_serving": 36,
                            "mixer_epilogue_serving": 36},
    }
    launches = {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_harness_") as root:
        wdir = os.path.join(root, "weights")
        for rel, sd in (("Restormer/denoising/gaussian_color_denoising_sigma15.pth",
                         restormer_state_dict(CONFIG, seed=SEED)),
                        (f"MaIR/denoising/MaIR_CDN_s{RECUR_SIGMA}.pth",
                         mair_state_dict(None, seed=SEED))):
            os.makedirs(os.path.dirname(os.path.join(wdir, rel)), exist_ok=True)
            torch.save({"params": sd}, os.path.join(wdir, rel))
        ds = os.path.join(root, "datasets", "denoising", "gaussian", "test", "CBSD68")
        os.makedirs(ds)
        for i, (h, w) in enumerate(HARNESS_IMAGES):
            imwrite_uint(os.path.join(ds, f"{i + 1:02d}.png"), synthetic_image(h, w, SEED + 7 + i))
        saved = os.environ.get("TPUIR_DATASET_DIR")
        os.environ["TPUIR_DATASET_DIR"] = os.path.join(root, "datasets")
        cell = dict(datasets=("CBSD68",), sigmas=(RECUR_SIGMA,), models=("Restormer", "MaIR"))
        for (precision, recur), want_chunk in per_chunk.items():
            tag = f"{precision}{' recur' if recur else ''}"
            kw = dict(weights_dir=wdir, save_images=False, device=device, precision=precision,
                      recur_bf16=recur)
            h = harness.Harness(results_dir=os.path.join(root, tag.replace(" ", "_")), **kw)
            _kernels.reset_launches()
            t0 = time.time()
            h.gaussian_color_nonblind(**cell)
            torch.cuda.synchronize()
            secs = time.time() - t0
            got = {k: n for k, n in _kernels.LAUNCHES.items() if n}
            want = {k: n * len(HARNESS_IMAGES) for k, n in want_chunk.items()}  # a chunk an image
            print(f"harness {tag}: {len(h.results_table)} rows in {secs:.1f} s; launches {got}",
                  flush=True)
            if got != want:
                fail(f"harness {tag}: launches {got}, expected {want}")
            path = h.save_results()
            with open(path) as f:
                header = f.readline().strip().split(",")
            if tuple(header) != harness.COLUMNS:
                fail(f"harness {tag}: CSV columns {header}")
            plain = plain_harness(results_dir=os.path.join(root, "plain"), **kw)
            plain.gaussian_color_nonblind(**cell)
            if [r["Model"] for r in h.results_table] != ["Restormer", "MaIR"]:
                fail(f"harness {tag}: rows {[r['Model'] for r in h.results_table]}")
            for row, ref in zip(h.results_table, plain.results_table):
                text = [c for c in harness.COLUMNS[:6] if row[c] != ref[c]]
                dp, ds_ = abs(row["PSNR"] - ref["PSNR"]), abs(row["SSIM"] - ref["SSIM"])
                print(f"harness {tag} row {row['Model']}: PSNR {row['PSNR']:.4f} dB SSIM "
                      f"{row['SSIM']:.5f} (plain path {ref['PSNR']:.4f} dB {ref['SSIM']:.5f}), "
                      f"{row['Avg_Time_ms']:.1f} ms an image", flush=True)
                if text or dp > HARNESS_PSNR_DB or ds_ > HARNESS_SSIM:
                    fail(f"harness {tag} row {row['Model']} against the plain path: columns "
                         f"{text} differ, PSNR by {dp:.4f} dB, SSIM by {ds_:.5f}")
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
        if saved is None:
            del os.environ["TPUIR_DATASET_DIR"]
        else:
            os.environ["TPUIR_DATASET_DIR"] = saved
    return launches


def write_plain_conv_checkpoints(wdir):
    """Phase 17's seeded checkpoints in the released formats under ``wdir``:
    DnCNN's ``.pth`` state dicts (gray sigma=25, color blind), REDNet's
    ``50.pt`` and the same weights as ``50.caffemodel`` under ``wdir/caffe``,
    DeblurGANv2's ``.h5`` pickles (``model``, DataParallel ``module.``
    keys). Returns the caffemodel's weights root."""
    import torch

    from tpuir_torch.models import dncnn, rednet
    from tpuir_torch.models.deblurgan import fpn_inception, fpn_mobilenet
    from tpuir_torch.weights.caffe import write_caffemodel

    def save(rel, obj):
        path = os.path.join(wdir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(obj, path)

    save("DnCNN/dncnn_25.pth", dncnn.init_state_dict(1, 17, seed=SEED))
    save("DnCNN/dncnn_color_blind.pth", dncnn.init_state_dict(3, 20, seed=SEED + 1))
    red = rednet.init_state_dict(seed=SEED + 2)
    save("REDNet/50.pt", red)
    caffe_root = os.path.join(wdir, "caffe")
    os.makedirs(os.path.join(caffe_root, "REDNet"))
    write_caffemodel(os.path.join(caffe_root, "REDNet", "50.caffemodel"),
                     {k: v.numpy() for k, v in red.items()})
    for variant, mod in (("mobilenet", fpn_mobilenet), ("inception", fpn_inception)):
        sd = mod.init_state_dict(seed=SEED + 3)
        save(f"DeblurGANv2/fpn_{variant}.h5", {"model": {f"module.{k}": v for k, v in sd.items()}})
    return caffe_root


def motion_blurred(img, length=9):
    """A horizontal box blur of ``length`` pixels (edges repeated): a
    synthetic motion-blurred input whose target is ``img``."""
    pad = np.pad(img.astype(np.float64), ((0, 0), (length // 2, length // 2), (0, 0)), "edge")
    out = sum(pad[:, i:i + img.shape[1]] for i in range(length)) / length
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def batch_invariance(model, chans, seed):
    """max|step(patch) - step(batch of 8)[3]| of ``model`` (parity) at its
    patch size, on random uint8 patches normalized by its own hook."""
    import torch

    ps = model.patch_size
    raw = (np.random.RandomState(seed).rand(8, ps, ps, chans) * 255).astype(np.uint8)
    x = torch.from_numpy(np.stack([model.normalize(p) for p in raw])).to(model.device)
    x = x.permute(0, 3, 1, 2)  # NHWC viewed as NCHW, as the engine hands chunks over
    batched, alone = model.step(x), model.step(x[3:4])
    return float((batched[3] - alone[0]).abs().max())


def phase_plain_conv(device, bsd68=PLAIN_BSD68, gopro=PLAIN_GOPRO):
    """The plain-conv families on the card (see phase 17 in the module
    docstring). Returns {cell: (parity Mpix/s, serving Mpix/s)}."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.ops import _kernels

    clean = synthetic_image(*bsd68, SEED + 40)
    gray = np.round(clean.astype(np.float64).mean(-1, keepdims=True)).astype(np.uint8)
    sharp = synthetic_image(*gopro, SEED + 41)
    blurred = motion_blurred(sharp)
    # (label, zoo route, weights root ("caffe": the caffemodel's), input,
    # target, host AWGN sigma or None)
    cells = [
        ("DnCNN gray sigma=25", ("denoising", "gaussian", "DnCNN", True, 25), "", gray, gray, 25),
        ("DnCNN color blind", ("denoising", "gaussian", "DnCNN", False, None), "", clean, clean,
         25),
        ("REDNet sigma=50 .pt", ("denoising", "gaussian", "REDNet", True, 50), "", gray, gray,
         50),
        ("REDNet sigma=50 .caffemodel", ("denoising", "gaussian", "REDNet", True, 50), "caffe",
         gray, gray, 50),
        ("DeblurGANv2 (MobileNet)", ("deblurring", "motion", "DeblurGANv2 (MobileNet)", False,
                                     None), "", blurred, sharp, None),
        ("DeblurGANv2 (Inception)", ("deblurring", "motion", "DeblurGANv2 (Inception)", False,
                                     None), "", blurred, sharp, None),
    ]
    rates, parity_out = {}, {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_plain_conv_") as wdir:
        caffe_root = write_plain_conv_checkpoints(wdir)
        for label, (task, subtask, name, is_gray, sigma), root, img, target, noise in cells:
            t0 = time.time()
            kw = dict(gray=is_gray, sigma=sigma, weights_dir=caffe_root if root else wdir)
            models = {p: zoo.get_model_instance(task, subtask, name, precision=p, device=device,
                                                **kw) for p in ("parity", "serving")}
            cpu_model = zoo.get_model_instance(task, subtask, name, device="cpu", **kw)
            for m in models.values():  # warm-up: cuDNN and allocator, not counted
                serve(m, [img], noise, [target])
            torch.cuda.synchronize()
            _kernels.reset_launches()
            served = {p: [serve(m, [img], noise, [target])[0] for _ in range(PLAIN_ROUNDS)]
                      for p, m in models.items()}
            torch.cuda.synchronize()
            launched = {k: n for k, n in _kernels.LAUNCHES.items() if n}
            if launched:
                fail(f"{label}: hand kernels launched on a plain-conv path: {launched}")
            h, w = img.shape[:2]
            ms = {p: float(np.median([r[1] for r in rounds])) for p, rounds in served.items()}
            for p, rounds in served.items():
                if any(not np.array_equal(r[0], rounds[0][0]) for r in rounds):
                    fail(f"{label}: the {p} path is not repeatable")
            (pred, _, psnr, ssim), (spred, _, spsnr, sssim) = (served["parity"][0],
                                                               served["serving"][0])
            (cpu_pred, _, _, _), = serve(cpu_model, [img], noise, [target])
            cpu_lsb = lsb(pred, cpu_pred)
            dpsnr = spsnr - psnr
            inv = batch_invariance(models["parity"], img.shape[2], SEED + 50)
            rates[label] = tuple(h * w / 1e3 / ms[p] for p in ("parity", "serving"))
            print(f"plain-conv {label}: {models['parity'].param_count:,} params, patch "
                  f"{models['parity'].patch_size} overlap {models['parity'].patch_overlap}, "
                  f"request {h}x{w}x{img.shape[2]}; parity PSNR {psnr:.4f} dB SSIM {ssim:.5f}, "
                  f"{ms['parity']:.1f} ms {rates[label][0]:.3f} Mpix/s; serving PSNR {spsnr:.4f} "
                  f"dB SSIM {sssim:.5f} (PSNR {dpsnr:+.4f} dB), {ms['serving']:.1f} ms "
                  f"{rates[label][1]:.3f} Mpix/s; card vs CPU {cpu_lsb} LSB; repeatable over "
                  f"{PLAIN_ROUNDS} rounds each; one patch alone vs in a batch of 8: max|d| "
                  f"{inv:.3e}; no hand-kernel launch  [{time.time() - t0:.0f} s]", flush=True)
            if cpu_lsb > 1:
                fail(f"{label}: card and CPU differ by {cpu_lsb} uint8 LSB")
            if abs(dpsnr) > SERVING_PSNR_DB:
                fail(f"{label}: serving PSNR {spsnr:.4f} dB against parity's {psnr:.4f}")
            if not inv <= PLAIN_BATCH_TOL:
                fail(f"{label}: a patch alone and in a batch of 8 differ by {inv:.3e}")
            parity_out[label] = pred
            del models, cpu_model
            torch.cuda.empty_cache()
    if not np.array_equal(parity_out["REDNet sigma=50 .pt"],
                          parity_out["REDNet sigma=50 .caffemodel"]):
        fail("REDNet from the .caffemodel differs from the same weights' .pt")
    print("plain-conv REDNet sigma=50: the .caffemodel serves the .pt's output bit for bit",
          flush=True)
    return rates


# Phase 18: (label, utils.profiling model, precision, per-chunk launches,
# engine batch) of the window's requests (utils.profiling.ENGINE_REQUESTS'
# sizes), then the requests that are only split. At batch 8 a request has
# 2-3 chunks, so the ring of min(4, chunks) staging buffers is never reused
# at max_in_flight 4; the batch-2 requests (5 and 10 chunks) refill every
# buffer and fill the window at each of WINDOWS.
WINDOW_CELLS = [
    ("Restormer sigma=25", "restormer", "parity", {"fused_transformer_block": 44}, 8),
    ("Restormer sigma=25", "restormer", "serving", {"fused_transformer_block_serving": 44}, 8),
    ("Restormer sigma=25", "restormer", "serving", {"fused_transformer_block_serving": 44}, 2),
    ("MaIR-CDN sigma=25", "mair", "parity", dict.fromkeys(
        ("mixer_prologue", "nss_scan", "mixer_epilogue"), MAIR_BLOCKS), 8),
    ("MaIR-CDN sigma=25", "mair", "serving", dict.fromkeys(MIXER_SERVING, MAIR_BLOCKS), 8),
    ("REDNet sigma=50", "rednet", "parity", {}, 8),
    ("REDNet sigma=50", "rednet", "serving", {}, 8),
    ("REDNet sigma=50", "rednet", "serving", {}, 2),
    ("MaIRUNet", "mairunet", "parity", dict.fromkeys(
        ("mixer_prologue", "nss_scan", "mixer_epilogue"), 44), 8),
]
WINDOWS = (1, 2, 4)
SPLIT_CELLS = [("DnCNN gray sigma=25", "dncnn"), ("DeblurGANv2 (MobileNet)", "deblurgan-mobilenet"),
               ("DeblurGANv2 (Inception)", "deblurgan-inception")]
DEMO_IMAGE = (200, 150)


def window_request(key):
    """Phase 18's request of ``key``: (image, host AWGN sigma or None), the
    earlier phases' requests of the same size."""
    from tpuir_torch.utils.profiling import ENGINE_REQUESTS

    (_, _, _, gray, _), (h, w), sigma = ENGINE_REQUESTS[key]
    if key in ("rednet", "dncnn"):
        clean = synthetic_image(h, w, SEED + 40)
        return np.round(clean.astype(np.float64).mean(-1, keepdims=True)).astype(np.uint8), sigma
    if key == "mairunet":
        return noisy_image(synthetic_image(h, w, SEED), SEED + 100), None
    if key.startswith("deblurgan"):
        return motion_blurred(synthetic_image(h, w, SEED + 41)), None
    return synthetic_image(h, w, SEED), sigma


def seeded_zoo_model(key, precision, wdir, device):
    from tpuir_torch import zoo
    from tpuir_torch.utils.profiling import ENGINE_REQUESTS

    (task, subtask, name, gray, sigma), _, _ = ENGINE_REQUESTS[key]
    return zoo.get_model_instance(task, subtask, name, gray=gray, sigma=sigma, weights_dir=wdir,
                                  precision=precision, device=device)


def print_split(label, precision, model, img, sigma):
    """Phase 18 (b): one request's host split and the card's."""
    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.utils.profiling import HOST_STEPS, card_line, engine_split, profiled_requests

    want, _ = run_model_inference(model, img, need_degradation=sigma is not None,
                                  noise_level=sigma)
    splits = []
    for _ in range(ROUNDS):
        out, ms = engine_split(model, img, sigma)
        if not np.array_equal(out, want):
            fail(f"{label} {precision}: the split's output differs from the engine's")
        splits.append(ms)
    host = {k: float(np.median([s[k] for s in splits])) for k in HOST_STEPS + ("wall",)}
    dev = profiled_requests(lambda: engine_split(model, img, sigma))
    h, w = img.shape[:2]
    card = card_line(dev) + (" (profiled)" if dev else "")
    print(f"split {label} {precision} {h}x{w}: wall {host['wall']:.2f} ms "
          f"{h * w / 1e3 / host['wall']:.3f} Mpix/s; host " + " ".join(
              f"{k} {host[k]:.2f}" for k in HOST_STEPS) + f"; {card}", flush=True)


def phase_window(device, cells=WINDOW_CELLS, split_cells=SPLIT_CELLS):
    """Phase 18 (a) and (b). Returns ({kernel: launches}, {(key, precision):
    (output, median ms at max_in_flight 4, {kernel: launches a chunk})} of
    the batch-8 cells, phase 21's single-device reference)."""
    import torch

    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.ops import _kernels
    from tpuir_torch.utils.profiling import write_seeded_checkpoint

    launches, served = {}, {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_window_") as wdir:
        for key in dict.fromkeys(cell[1] for cell in cells):
            write_seeded_checkpoint(key, wdir, seed=SEED)
        for label, key, precision, per_chunk, batch in cells:
            model = seeded_zoo_model(key, precision, wdir, device)
            model.batch_size = batch
            img, sigma = window_request(key)
            h, w = img.shape[:2]
            serve_kw = dict(need_degradation=sigma is not None, noise_level=sigma)
            run_model_inference(model, img, **serve_kw)  # warm-up, not counted
            torch.cuda.synchronize()
            chunks = chunks_for(model, h, w)
            want = {k: n * chunks for k, n in per_chunk.items()}
            outs, ms = [], {m: [] for m in WINDOWS}
            for r in range(ROUNDS):
                for mif in WINDOWS[r % len(WINDOWS):] + WINDOWS[:r % len(WINDOWS)]:
                    _kernels.reset_launches()
                    pred, t_ms = run_model_inference(model, img, max_in_flight=mif, **serve_kw)
                    torch.cuda.synchronize()
                    got = {k: n for k, n in _kernels.LAUNCHES.items() if n}
                    if got != want:
                        fail(f"window {label} {precision} max_in_flight={mif}: launches {got}, "
                             f"expected {want}")
                    for k, n in got.items():
                        launches[k] = launches.get(k, 0) + n
                    outs.append(pred)
                    ms[mif].append(t_ms)
            if any(not np.array_equal(o, outs[0]) for o in outs):
                fail(f"window {label} {precision}: outputs differ across windows or rounds")
            print(f"window {label} {precision} {h}x{w} batch {batch} ({chunks} chunks): bit-equal "
                  f"over max_in_flight {', '.join(map(str, WINDOWS))}, {ROUNDS} rounds; launches "
                  f"a serve {want}; engine " + ", ".join(
                      f"max_in_flight={m} {h * w / 1e3 / float(np.median(v)):.3f} Mpix/s"
                      for m, v in ms.items()), flush=True)
            if batch == 8:
                served[(key, precision)] = (outs[0], float(np.median(ms[4])), per_chunk)
                print_split(label, precision, model, img, sigma)
            del model
            torch.cuda.empty_cache()
        for label, key in split_cells:
            write_seeded_checkpoint(key, wdir, seed=SEED)
            for precision in ("parity", "serving"):
                model = seeded_zoo_model(key, precision, wdir, device)
                img, sigma = window_request(key)
                run_model_inference(model, img, need_degradation=sigma is not None,
                                    noise_level=sigma)  # warm-up
                print_split(label, precision, model, img, sigma)
                del model
                torch.cuda.empty_cache()
    return launches, served


def phase_entry_points(device, demo_image=DEMO_IMAGE):
    """Phase 18 (c) and (d). Returns {kernel: launches}."""
    import torch

    from tpuir_torch import demo_core, zoo
    from tpuir_torch.config import get_patch_config
    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.core.image_io import imread_uint8, imwrite_uint
    from tpuir_torch.core.metrics import calculate_metrics
    from tpuir_torch.ops import _kernels
    from tpuir_torch.scripts import compute_flops, test_demo, test_patch_size, validate_serving
    from tpuir_torch.utils.profiling import write_seeded_checkpoint

    per_chunk = {"Restormer": {"fused_transformer_block": 44},
                 "MaIR": dict.fromkeys(("mixer_prologue", "nss_scan", "mixer_epilogue"),
                                       MAIR_BLOCKS)}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_entry_") as root:
        wdir = os.path.join(root, "weights")
        for key in ("restormer", "mair"):
            write_seeded_checkpoint(key, wdir, seed=SEED)
        clean = synthetic_image(*demo_image, SEED + 60)
        label = "Gaussian (Color, Non-blind)"
        for name, want_chunk in per_chunk.items():
            built = []

            def get_model(*args, **kw):
                built.append(zoo.get_model_instance(*args, weights_dir=wdir, **kw))
                return built[-1]

            pc = get_patch_config("denoising", "gaussian", name)
            _kernels.reset_launches()
            before, after, t = demo_core.run_restoration(
                clean, label, name, SIGMA, True, pc["patch_size"], pc["patch_overlap"],
                device_name=str(device), get_model=get_model)
            torch.cuda.synchronize()
            got = {k: n for k, n in _kernels.LAUNCHES.items() if n}
            model = built[0]
            want = {k: n * chunks_for(model, *before.shape[:2]) for k, n in want_chunk.items()}
            if got != want or model.device != device:
                fail(f"demo {name}: launches {got} on {model.device}, expected {want} on {device}")
            direct, _ = run_model_inference(model, before, patch_size=pc["patch_size"],
                                            patch_overlap=pc["patch_overlap"])
            if not np.array_equal(direct, after):
                fail(f"demo {name}: run_restoration differs from run_model_inference")
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            print(f"demo run_restoration {name} on {device} {demo_image[0]}x{demo_image[1]} "
                  f"sigma={SIGMA} ({t}): equals run_model_inference bit for bit; launches {got}",
                  flush=True)
            del built, model

        demo_dir = os.path.join(root, "demo")
        os.makedirs(demo_dir)
        suite = next(s for s in test_demo.SUITES if s[0] == "denoising_gaussian_color_nonblind")
        prefix = suite[0]
        noisy = noisy_image(clean, SEED + 61, SIGMA)
        imwrite_uint(os.path.join(demo_dir, f"{prefix}_noisy.bmp"), noisy)
        imwrite_uint(os.path.join(demo_dir, f"{prefix}_target.png"), clean)
        test_demo.run_suite(*suite, demo_dir=demo_dir, weights_dir=wdir, show=False,
                            device=str(device))
        for name in suite[5]:
            path = os.path.join(demo_dir, f"{prefix}_result_{name}.png")
            if not os.path.exists(path):
                fail(f"test_demo wrote no {os.path.basename(path)}")
            psnr, ssim = calculate_metrics(imread_uint8(path), clean)
            if not (np.isfinite(psnr) and np.isfinite(ssim)):
                fail(f"test_demo {name}: PSNR {psnr} SSIM {ssim}")
            print(f"test_demo {prefix} {name}: PNG written, PSNR {psnr:.4f} dB SSIM {ssim:.5f}",
                  flush=True)

        name, build, in_ch = next(t for t in compute_flops.model_table()
                                  if t[0] == "DnCNN (nonblind, gray)")
        trials = []
        fits = test_patch_size.card_fits(test_patch_size.bundle(name, build, in_ch, device),
                                         in_ch)
        best = test_patch_size.find_max_patch_size(lambda s: trials.append(s) or fits(s))
        print(f"test_patch_size {name}: trials {trials}, max patch size {best}", flush=True)

        res = validate_serving.validate(["DnCNN", "Restormer"], os.path.join(root, "none"),
                                        device=device)
        path = os.path.join(root, "serving_deltas_torch.json")
        with open(path, "w") as f:
            json.dump(res, f)
        for fam, entry in res["trained_like"].items():
            if abs(entry["psnr_delta_db"]) > SERVING_PSNR_DB:
                fail(f"validate_serving {fam}: serving {entry['psnr_delta_db']:+.4f} dB "
                     "from parity")
        print(f"validate_serving: {os.path.basename(path)} written ({os.path.getsize(path)} "
              f"bytes); trained-like serving - parity PSNR " + ", ".join(
                  f"{fam} {-e['psnr_delta_db']:+.4f} dB ({e['weights']})"
                  for fam, e in res["trained_like"].items()), flush=True)
    return launches


# -- phase 19: training -------------------------------------------------------

TRAIN_OPTIONS = "options/train/GaussianColorDenoising_RestormerSigma25.yml"
MAIR_TEST_OPTIONS = "options/test/test_MaIR_CDN_s25.yml"
# MaIR-CDN's training crop and batch, cut from the Restormer file's first
# progressive stage (patch 128, batch 8) for the phase's time
TRAIN_CROP, TRAIN_BATCH = 64, 4
TRAIN_ITERS, RESUME_ITERS = 3, 5
TRAIN_LOSS_RTOL = 1e-5  # a step's loss, kernel forwards against plain forwards
# a gradient tensor, kernel forwards against plain forwards:
# |g - g_twin| <= 1e-3 |g_twin| (L2 norms), where the forward's K2 tolerance puts it
TRAIN_GRAD_RTOL = 1e-3
FUNCTION_BATCH, FUNCTION_SIDE = 2, 64  # phase 19 (b): a MaIR-CDN mixer's level
FUNCTION_K3_LEVEL = (66, 60)  # H not a multiple of scan_len: the sequence route


def write_pngs(d, n, h, w, seed):
    """``n`` seeded color PNGs of h x w under ``d``."""
    import cv2

    os.makedirs(d, exist_ok=True)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"{i:03d}.png"), synthetic_image(h, w, seed + i))
    return d


def rel_l2(got, want) -> float:
    import torch

    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / max(float(torch.linalg.vector_norm(want)),
                                                           1e-30))


class StepRecorder:
    """Stands in for ``train/trainer.train_step`` inside ``train/model.py``
    while a pipeline runs: the same three calls on the train state
    (``forward_loss``, ``backward``, ``apply_gradients``), each timed with
    CUDA events, with the kernel launches of the forward and of the
    backward, the peak memory, and what the twin needs: the batch, the
    weights at the step's start and the gradients."""

    def __init__(self):
        self.steps = []

    def __call__(self, state, lq, gt, loss_fn, grad_clip=None, grads=None):
        import torch

        from tpuir_torch.ops import _kernels

        rec = {"lq": lq.detach().clone(), "gt": gt.detach().clone(),
               "weights": {k: v.detach().clone() for k, v in state.net.state_dict().items()}}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(_kernels.LAUNCHES)
        ev[0].record()
        loss = state.forward_loss(lq, gt, loss_fn)
        ev[1].record()
        mid = dict(_kernels.LAUNCHES)
        state.backward(loss)
        ev[2].record()
        after = dict(_kernels.LAUNCHES)
        rec["grads"] = {k: p.grad.detach().clone() for k, p in state.net.named_parameters()}
        if grads is not None:  # the optimizer fed another run's gradients
            for k, p in state.net.named_parameters():
                p.grad.copy_(grads[k])
        gnorm = state.apply_gradients(grad_clip)
        ev[3].record()
        ev[3].synchronize()
        rec["forward_launches"] = {k: mid[k] - before[k] for k in mid if mid[k] != before[k]}
        rec["backward_launches"] = {k: after[k] - mid[k] for k in mid if after[k] != mid[k]}
        rec["ms"] = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["loss"] = float(loss.detach())
        rec["after"] = {k: v.detach().clone() for k, v in state.net.state_dict().items()}
        self.steps.append(rec)
        return {"loss": loss.detach(), "grad_norm": gnorm}


def print_steps(label, steps, first=1):
    for i, rec in enumerate(steps, first):
        f, b, o = rec["ms"]
        print(f"  {label} step {i}: loss {rec['loss']:.7e}  forward {f:.1f} ms  backward "
              f"{b:.1f} ms  optimizer {o:.1f} ms  (step {f + b + o:.1f} ms)  peak "
              f"{rec['peak_gb']:.2f} GB  forward launches {rec['forward_launches']}  backward "
              f"launches {rec['backward_launches'] or 'none'}", flush=True)


def mair_train_options(device, root, gt_dir, val_dir, total_iter, auto_resume=False):
    """MaIR-CDN's training options: ``network_g`` of the sigma=25 test file,
    the Restormer sigma=25 file's ``train`` section (AdamW 3e-4, weight
    decay 1e-4, L1, the gradient clip, the cyclic cosine schedule, mixup),
    Gaussian denoising at sigma 25 on ``gt_dir``'s PNGs, crop ``TRAIN_CROP``,
    batch ``TRAIN_BATCH``; a save and a validation at iteration 3."""
    from tpuir_torch.train.options import yaml_load

    train = dict(yaml_load(TRAIN_OPTIONS)["train"], total_iter=total_iter)
    return {
        "name": "mair_cdn_s25", "model_type": "MambaIRModel", "scale": 1, "manual_seed": 10,
        "is_train": True, "device": str(device), "auto_resume": auto_resume,
        "datasets": {
            "train": {"name": "synthetic", "type": "Dataset_GaussianDenoising", "phase": "train",
                      "sigma_type": "constant", "sigma_range": 25, "in_ch": 3,
                      "dataroot_gt": gt_dir, "dataroot_lq": "none", "geometric_augs": True,
                      "use_shuffle": True, "batch_size_per_gpu": TRAIN_BATCH,
                      "gt_size": TRAIN_CROP, "dataset_enlarge_ratio": 1, "scale": 1},
            "val": {"name": "synthetic_val", "type": "Dataset_GaussianDenoising",
                    "phase": "val", "sigma_test": 25, "in_ch": 3, "dataroot_gt": val_dir,
                    "dataroot_lq": "none", "scale": 1},
        },
        "network_g": dict(yaml_load(MAIR_TEST_OPTIONS)["network_g"]),
        "path": {"models": os.path.join(root, "models"),
                 "training_states": os.path.join(root, "training_states"), "log": None},
        "train": train,
        "val": {"window_size": 8, "val_freq": 3, "use_image": True,
                "metrics": {"psnr": {"type": "calculate_psnr", "crop_border": 0,
                                     "test_y_channel": False}}},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 3, "use_tb_logger": False},
    }


def train_mair(device, root):
    """Phase 19 (a): MaIR-CDN at full width and depth trained for 3
    iterations through ``train_pipeline`` on the kernels, saved, resumed to
    5; the same steps again with the Functions' plain forwards (the twin),
    each from the kernel run's weights at the step's start; returns the
    kernel run's launches."""
    from unittest import mock

    import torch

    from tpuir_torch.ops import _kernels, kernel_grad
    from tpuir_torch.train import model as train_model
    from tpuir_torch.train.pipeline import train_pipeline

    gt_dir = write_pngs(os.path.join(root, "gt"), TRAIN_BATCH, 96, 80, seed=100)
    val_dir = write_pngs(os.path.join(root, "val"), 2, 64, 48, seed=200)
    rec = StepRecorder()
    _kernels.reset_launches()
    t0 = time.time()
    with mock.patch.object(train_model, "train_step", rec):
        result = train_pipeline(root, mair_train_options(device, root, gt_dir, val_dir,
                                                         TRAIN_ITERS))
        print(f"  MaIR-CDN trained to iteration {result['iter']} "
              f"[{time.time() - t0:.0f} s]", flush=True)
        for name in ("models/net_g_3.pth", "training_states/3.state"):
            if not os.path.exists(os.path.join(root, name)):
                fail(f"MaIR-CDN training wrote no {name}")
        resumed = train_pipeline(root, mair_train_options(device, root, gt_dir, val_dir,
                                                          RESUME_ITERS, auto_resume=True))
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    if result["iter"] != TRAIN_ITERS or resumed["iter"] != RESUME_ITERS or \
            resumed["model"].state.step != RESUME_ITERS or len(rec.steps) != RESUME_ITERS:
        fail(f"MaIR-CDN training: iterations {result['iter']}, resumed {resumed['iter']} "
             f"(step {resumed['model'].state.step}), {len(rec.steps)} steps recorded")
    net = result["model"].network_opt
    print(f"  MaIR-CDN (embed {net['embed_dim']}, depths {net['depths']}, d_state "
          f"{net['d_state']}; crop {TRAIN_CROP}, batch "
          f"{TRAIN_BATCH}, cut from the Restormer file's first stage, patch 128 and batch 8, "
          f"for the phase's time): iterations 1-3, a save, auto_resume to 5; launches in "
          f"the run, validation included: {launches}", flush=True)
    print_steps("kernel path", rec.steps)
    for i, r in enumerate(rec.steps, 1):
        want = {"mixer_prologue": MAIR_BLOCKS, "nss_scan": MAIR_BLOCKS,
                "mixer_epilogue": MAIR_BLOCKS}
        if r["forward_launches"] != want or r["backward_launches"]:
            fail(f"MaIR-CDN step {i}: forward launches {r['forward_launches']} (want {want}), "
                 f"backward launches {r['backward_launches']} (want none)")
    # the twin: the Functions' plain forwards, the same batches, each step
    # from the kernel run's weights, its optimizer fed the kernel run's grads
    twin_opt = mair_train_options(device, os.path.join(root, "twin"), gt_dir, val_dir,
                                  TRAIN_ITERS)
    twin = train_model.build_model(twin_opt)
    twin_rec = StepRecorder()
    with kernel_grad.plain_forwards():
        for r in rec.steps[:TRAIN_ITERS]:
            twin.net_g.load_state_dict(r["weights"])
            twin_rec(twin.state, r["lq"], r["gt"], twin.cri_pix, twin.grad_clip, grads=r["grads"])
    print_steps("plain twin ", twin_rec.steps)
    for i, (r, t) in enumerate(zip(rec.steps, twin_rec.steps), 1):
        if t["forward_launches"] or t["backward_launches"]:
            fail(f"the plain twin launched kernels at step {i}")
        d = abs(r["loss"] - t["loss"]) / abs(t["loss"])
        worst = max(((rel_l2(r["grads"][k], t["grads"][k]), k) for k in t["grads"]))
        same = all(torch.equal(r["after"][k], t["after"][k]) for k in r["after"])
        print(f"  step {i}: loss rel diff {d:.2e} (limit {TRAIN_LOSS_RTOL:g}); gradients, worst "
              f"tensor {worst[1]}: rel L2 {worst[0]:.2e} (limit {TRAIN_GRAD_RTOL:g}); the "
              f"optimizer fed the kernel run's gradients: weights "
              f"{'bit for bit' if same else 'DIFFER'}", flush=True)
        if d > TRAIN_LOSS_RTOL:
            fail(f"MaIR-CDN step {i}: loss {r['loss']} against the plain twin's {t['loss']}")
        if i == 1 and worst[0] > TRAIN_GRAD_RTOL:
            fail(f"MaIR-CDN step 1: gradient {worst[1]} {worst[0]:.2e} from the plain twin's")
        if not same:
            fail(f"MaIR-CDN step {i}: the same gradients gave other weights")
    base = torch.cuda.memory_allocated() / 1e9
    plain_peak = max(t["peak_gb"] for t in twin_rec.steps)
    print(f"  memory: the backward recomputes one plain mixer at a time (peak {plain_peak:.2f} "
          f"GB, {base:.2f} GB held after the steps); a fused=False graph would keep all 36 "
          f"plain scans' activations, about 36 x {plain_peak - base:.1f} GB, more than the "
          f"card's 80 GB", flush=True)
    median = lambda recs, j: float(np.median([x["ms"][j] for x in recs[1:]]))  # noqa: E731
    print(f"  train step at MaIR-CDN@{TRAIN_CROP} batch {TRAIN_BATCH}, median of steps 2-"
          f"{len(rec.steps)} (kernel) and 2-{len(twin_rec.steps)} (twin): forward "
          f"{median(rec.steps, 0):.1f} / {median(twin_rec.steps, 0):.1f} ms, backward "
          f"{median(rec.steps, 1):.1f} / {median(twin_rec.steps, 1):.1f} ms, optimizer "
          f"{median(rec.steps, 2):.1f} / {median(twin_rec.steps, 2):.1f} ms; peak "
          f"{max(x['peak_gb'] for x in rec.steps):.2f} / {plain_peak:.2f} GB", flush=True)
    return launches


def function_grads(device):
    """Phase 19 (b): each differentiable wrapper alone at a MaIR-CDN mixer's
    full width (d_model 180, d_inner 234, d_state 16), batch
    ``FUNCTION_BATCH``: the Function's forward outputs against the plain
    version's at the kernel's tolerance of phases 4, 6 and 8, the gradient
    of a seeded cotangent with the kernel forward against direct autograd
    of the plain version, one launch in the forward and none in the
    backward."""
    import torch

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.models.mair import SSMixer, init_state_dict
    from tpuir_torch.ops import _kernels, nss_epilogue, nss_fused, nss_prologue, nss_stripe
    from tpuir_torch.ops import scan_fused_proj
    from tpuir_torch.ops.scan_ids import scan_index_tensors

    cfg = zoo.MAIR_CDN_CONFIG
    mixer = SSMixer(cfg["embed_dim"], cfg["d_state"], cfg["ssm_ratio"], cfg["scan_len"])
    prefix = "layers.0.residual_group.blocks.0.self_attention."
    mixer.load_state_dict({k[len(prefix):]: v for k, v in init_state_dict(cfg, SEED).items()
                           if k.startswith(prefix)})
    mixer = mixer.to(device)
    di, n = mixer.d_inner, mixer.d_state
    A = -torch.exp(mixer.A_logs.detach()).reshape(4, di, n)
    scan_w = [mixer.x_proj_weight.detach(), mixer.dt_projs_weight.detach(), A,
              mixer.Ds.detach().reshape(4, di), mixer.dt_projs_bias.detach()]
    rng = np.random.RandomState(SEED)
    s = FUNCTION_SIDE
    h = torch.from_numpy((rng.randn(FUNCTION_BATCH, s, s, cfg["embed_dim"]) * 0.5)
                         .astype(np.float32)).to(device)
    pro_w = [mixer.in_proj.weight.detach(), mixer.conv2d.weight.detach(),
             mixer.conv2d.bias.detach()]
    with torch.no_grad(), true_float32():
        x, z = nss_prologue.mixer_prologue_plain(h, *pro_w)
        y, pooled = nss_stripe.nss_scan_plain(x, *scan_w, 4, False)
        gates = torch.sigmoid(torch.randn(FUNCTION_BATCH, 4, di, device=device,
                                          generator=torch.Generator(device).manual_seed(1)))
        hk, wk = FUNCTION_K3_LEVEL
        h3 = torch.from_numpy((rng.randn(FUNCTION_BATCH, hk, wk, cfg["embed_dim"]) * 0.5)
                              .astype(np.float32)).to(device)
        x3, _ = nss_prologue.mixer_prologue_plain(h3, *pro_w)
        ids, _ = scan_index_tensors(hk, wk, 4, 0, device)
        xs = x3.reshape(FUNCTION_BATCH, hk * wk, di)[:, ids].contiguous()
    ln = [mixer.out_norm.weight.detach(), mixer.out_norm.bias.detach(),
          mixer.out_proj.weight.detach()]
    plain_bound = lambda g, w: compare(g, w, ATOL, RTOL)  # noqa: E731
    scan_bound = lambda g, w: compare(g, w, SCAN_ATOL, SCAN_RTOL)  # noqa: E731
    cases = {
        "mixer_prologue": (nss_prologue.mixer_prologue, nss_prologue.mixer_prologue_plain,
                           [h, *pro_w], (), plain_bound),
        "nss_scan": (nss_stripe.nss_scan, nss_stripe.nss_scan_plain, [x, *scan_w], (4, True),
                     compare_scan),
        "mixer_epilogue": (nss_epilogue.mixer_epilogue, nss_epilogue.mixer_epilogue_plain,
                           [y, gates, z, *ln], (), plain_bound),
        "nss_scan_fused": (nss_fused.nss_scan_fused, nss_fused.nss_scan_fused_plain,
                           [x, *scan_w], (4, True), compare_fused),
        "selective_scan_fused_proj": (scan_fused_proj.selective_scan_fused_proj,
                                      scan_fused_proj.selective_scan_fused_proj_plain,
                                      [xs, *scan_w], (), scan_bound),
    }
    for name, (wrapper, plain, tensors, static, check) in cases.items():
        forwards, grads, times, counts = [], [], [], []
        for fn in (wrapper, plain):
            ts = [t.detach().clone().requires_grad_() for t in tensors]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with true_float32():
                before = sum(_kernels.LAUNCHES.values())
                ev[0].record()
                outs = fn(*ts, *static)
                outs = outs if isinstance(outs, tuple) else (outs,)
                ev[1].record()
                mid = sum(_kernels.LAUNCHES.values())
                forwards.append(tuple(o.detach() for o in outs))
                g = torch.Generator(device).manual_seed(7)
                loss = sum((o * torch.randn(o.shape, generator=g, device=device)).sum()
                           for o in outs)
                grads.append(torch.autograd.grad(loss, ts))
                ev[2].record()
                ev[2].synchronize()
            counts.append((mid - before, sum(_kernels.LAUNCHES.values()) - mid))
            times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        errs = [rel_l2(g, w) for g, w in zip(*grads)]
        fwd_err, fwd_ok = check(*forwards)
        shape = "x".join(map(str, tensors[0].shape))
        print(f"  {name} at {shape}: forward max|d| {fwd_err:.3e} "
              f"({'ok' if fwd_ok else 'MISS'}); gradients rel L2 {max(errs):.2e} (limit "
              f"{TRAIN_GRAD_RTOL:g}; by input {', '.join(f'{e:.1e}' for e in errs)}); launches "
              f"forward {counts[0][0]}, backward {counts[0][1]}; kernel forward "
              f"{times[0][0]:.2f} ms, plain forward {times[1][0]:.2f} ms, backward (the "
              f"plain recompute and its gradient) {times[0][1]:.2f} ms", flush=True)
        if not fwd_ok:
            fail(f"{name}: the Function's kernel forward disagrees with its plain version")
        if max(errs) > TRAIN_GRAD_RTOL:
            fail(f"{name}: the kernel forward's gradients are {max(errs):.2e} from the plain "
                 f"version's")
        if counts[0] != (1, 0) or counts[1] != (0, 0):
            fail(f"{name}: launches {counts}, want one in the kernel forward and none else")


def train_restormer(device, root):
    """Phase 19 (c): the Restormer sigma=25 option file as it is, parsed with
    ``parse_options`` (``--force_yml`` points its dataroots at synthetic
    PNGs and cuts it to 3 iterations), at its first progressive stage
    (patch 128, batch 8), full width, built plain: no K1 launch; a save,
    the zoo serving ``net_g_3.pth`` within 1 LSB of the trained network,
    and an auto_resume to iteration 5."""
    import dataclasses
    import shutil
    from unittest import mock

    from tpuir_torch import zoo
    from tpuir_torch.core.engine import run_model_inference
    from tpuir_torch.ops import _kernels
    from tpuir_torch.train import model as train_model
    from tpuir_torch.train.options import parse_options
    from tpuir_torch.train.pipeline import train_pipeline

    gt_dir = write_pngs(os.path.join(root, "gt"), 8, 400, 400, seed=300)
    val_dir = write_pngs(os.path.join(root, "val"), 2, 64, 48, seed=400)

    def options(total_iter, *extra):
        force = [f"datasets:train:dataroot_gt={gt_dir}", f"datasets:val:dataroot_gt={val_dir}",
                 f"train:total_iter={total_iter}", "logger:print_freq=1",
                 "logger:save_checkpoint_freq=3", "logger:use_tb_logger=false", "val:val_freq=3"]
        opt, _ = parse_options(root, True, ["-opt", TRAIN_OPTIONS, "--device", str(device),
                                            *extra, "--force_yml", *force])
        return opt

    rec = StepRecorder()
    _kernels.reset_launches()
    t0 = time.time()
    with mock.patch.object(train_model, "train_step", rec):
        result = train_pipeline(root, options(TRAIN_ITERS))
        models = result["model"].opt["path"]["models"]
        trained = result["model"].net_g
        print(f"  Restormer ({TRAIN_OPTIONS}): trained to iteration {result['iter']} "
              f"[{time.time() - t0:.0f} s]; checkpoints {sorted(os.listdir(models))}",
              flush=True)
        if any(_kernels.LAUNCHES.values()):
            fail(f"Restormer training launched kernels: {_kernels.LAUNCHES} (tpuir trains the "
                 f"plain Restormer)")
        shapes = {tuple(r["lq"].shape) for r in rec.steps}
        if shapes != {(8, 3, 128, 128)}:
            fail(f"Restormer's first progressive stage gave batches {shapes}")
        wdir = os.path.join(root, "weights")
        dst = os.path.join(wdir, "Restormer", "denoising", "gaussian_color_denoising_sigma25.pth")
        os.makedirs(os.path.dirname(dst))
        shutil.copy(os.path.join(models, "net_g_3.pth"), dst)
        served = zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False,
                                        sigma=SIGMA, weights_dir=wdir, device=device)
        own = dataclasses.replace(served, net=trained.eval())
        img = synthetic_image(200, 150, seed=500)
        _kernels.reset_launches()
        got, _ = run_model_inference(served, img, need_degradation=True, noise_level=SIGMA)
        k1 = _kernels.LAUNCHES["fused_transformer_block"]
        want, _ = run_model_inference(own, img, need_degradation=True, noise_level=SIGMA)
        print(f"  the zoo serves net_g_3.pth (K1: {k1} launches) within {lsb(got, want)} LSB of "
              f"the trained network's own forward (plain blocks)", flush=True)
        if lsb(got, want) > 1 or k1 == 0:
            fail(f"the zoo's net_g_3.pth is {lsb(got, want)} LSB from the trained network "
                 f"({k1} K1 launches)")
        trained.train()
        resumed = train_pipeline(root, options(RESUME_ITERS, "--auto_resume"))
    if resumed["iter"] != RESUME_ITERS or resumed["model"].state.step != RESUME_ITERS:
        fail(f"Restormer resumed to iteration {resumed['iter']}")
    print_steps("Restormer", rec.steps)


def phase_training(device):
    """Phase 19: training on the card. (a) MaIR-CDN at full width and depth
    through ``train_pipeline`` on K6, K2 and K7 (36 launches of each a
    step's forward, none in its backward), with a save and an auto_resume,
    held step by step against its plain-forward twin; (b) each of the five
    differentiable wrappers alone at full width; (c) the Restormer option
    file trained plain, its checkpoint served by the zoo. Returns the
    launches of (a)'s training run."""
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_train_") as root:
        t0 = time.time()
        launches = train_mair(device, os.path.join(root, "mair"))
        print(f"[19a MaIR-CDN training {time.time() - t0:.0f} s]", flush=True)
        t0 = time.time()
        function_grads(device)
        print(f"[19b Functions {time.time() - t0:.0f} s]", flush=True)
        t0 = time.time()
        train_restormer(device, os.path.join(root, "restormer"))
        print(f"[19c Restormer training {time.time() - t0:.0f} s]", flush=True)
    return launches


# -- phase 20: DeblurGANv2 training ---------------------------------------------

GAN_SIDE = 256  # the released recipe's crop
GAN_SOURCE_SIDE = 288  # the synthetic pair the crop is cut from
GAN_STEPS, RAGAN_STEPS = 5, 3
GAN_SEED = 2200
# tpuir's documented default (``tpuir/models/deblurgan/``, the released
# config): FPN-Inception, double_gan with 3-layer PatchGAN and instance
# norm, WGAN-GP, the perceptual content loss, adv_lambda 0.001, Adam 1e-4
RELEASED = {"d_name": "double_gan", "d_layers": 3, "norm_layer": "instance",
            "content_loss": "perceptual", "disc_loss": "wgan-gp", "adv_lambda": 0.001}
RAGAN = {"d_name": "patch_gan", "d_layers": 3, "norm_layer": "instance",
         "content_loss": "l1", "disc_loss": "ragan-ls", "adv_lambda": 0.001}
GAN_LR = 1e-4
GAN_LOSS_RTOL = 1e-4  # a loss, card against CPU
GAN_OUT_ATOL = 1e-4  # a network's output, card against CPU
# a gradient tensor whose CPU norm is below this share of the whole
# gradient's is zero by construction (a conv bias an instance norm
# follows: the norm takes the mean out), and rounding noise on both sides
GAN_ZERO_SHARE = 1e-5
FID_IMAGES, FID_SIDE = 4, 299
FID_ATOL, FID_ZERO = 1e-4, 1e-3
SSIM_ATOL = 1e-5


def gan_pair(device, seed=GAN_SEED):
    """A seeded sharp/blurred pair at the recipe's crop, NCHW in [-1, 1]:
    a synthetic image and its seeded box blur (5, 7 or 9 wide, reflect
    borders) through ``deblurgan_aug``'s paired geometric transforms and
    random crop and its [-1, 1] normalize."""
    import torch
    import torch.nn.functional as F

    from tpuir_torch.train import deblurgan_aug

    rng = np.random.RandomState(seed)
    sharp = synthetic_image(GAN_SOURCE_SIDE, GAN_SOURCE_SIDE, seed)
    k = int(rng.choice([5, 7, 9]))
    t = torch.from_numpy(sharp.astype(np.float32)).permute(2, 0, 1)[None]
    blurred = F.avg_pool2d(F.pad(t, (k // 2,) * 4, mode="reflect"), k, stride=1)
    blurred = np.clip(np.round(blurred[0].permute(1, 2, 0).numpy()), 0, 255).astype(np.uint8)
    blurred, sharp = deblurgan_aug.get_transforms(GAN_SIDE, "geometric", "random")(
        blurred, sharp, rng)
    blurred, sharp = deblurgan_aug.get_normalize()(blurred, sharp)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).permute(2, 0, 1)[None].to(device)
                 for a in (blurred, sharp))


def weights_of(net):
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def grads_of(net):
    import torch

    return {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().clone()
            for k, p in net.named_parameters()}


def check_grads(label, got, want, rtol=TRAIN_GRAD_RTOL):
    """Each gradient tensor within ``rtol`` relative L2 of the CPU's; one
    that is zero by construction (``GAN_ZERO_SHARE``) rounding noise on
    both. Returns (worst relative L2, its tensor, tensors held as zero)."""
    import torch

    total = float(torch.sqrt(sum((w.double() ** 2).sum() for w in want.values())))
    worst, zeros = (0.0, ""), 0
    for k, w in want.items():
        if float(torch.linalg.vector_norm(w.double())) <= GAN_ZERO_SHARE * total:
            zeros += 1
            if float(torch.linalg.vector_norm(got[k].double())) > GAN_ZERO_SHARE * total:
                fail(f"{label}: gradient {k} is zero by construction on the CPU, not on the card")
            continue
        worst = max(worst, (rel_l2(got[k], w), k))
    if worst[0] > rtol:
        fail(f"{label}: gradient {worst[1]} is {worst[0]:.2e} relative L2 from the CPU's")
    return worst[0], worst[1], zeros


def check_loss(label, got, want, rtol=GAN_LOSS_RTOL):
    if not (np.isfinite(got) and np.isfinite(want)):
        fail(f"{label}: a loss is not finite ({got}, {want})")
    err = abs(got - want) / max(abs(want), 1e-30)
    if err > rtol:
        fail(f"{label}: {got:.8e} on the card, {want:.8e} on the CPU ({err:.2e} relative)")
    return err


class GanRun:
    """One DeblurGANv2 configuration on a device: the generator, the
    discriminators (``get_discriminator``), the losses (``get_loss``) and
    Adam at ``GAN_LR`` for G and for the discriminators together, all from
    the given state dicts, in ``dtype`` (float64 for the gradient twins)."""

    def __init__(self, cfg, device, g_cls, g_sd, d_sds, vgg_sd, dtype=None):
        from tpuir_torch.models.deblurgan import discriminators
        from tpuir_torch.models.deblurgan.norms import load_checkpoint
        from tpuir_torch.train import deblurgan_losses
        from tpuir_torch.train.trainer import build_optimizer

        self.cfg, self.device = cfg, device
        self.g = load_checkpoint(g_cls(), g_sd).to(device).train()
        self.ds = discriminators.get_discriminator(cfg, device=device)
        for k, d in self.ds.items():
            d.load_state_dict(d_sds[k])
        self.content, self.disc_loss = deblurgan_losses.get_loss(cfg, vgg_state_dict=vgg_sd,
                                                                 device=device)
        if dtype is not None:
            for net in (self.g, *self.ds.values(), getattr(self.content, "vgg", None)):
                if net is not None:
                    net.to(dtype)
        self.g_opt = build_optimizer({"type": "Adam", "lr": GAN_LR}, list(self.g.parameters()))
        self.d_opt = build_optimizer({"type": "Adam", "lr": GAN_LR},
                                     [p for d in self.ds.values() for p in d.parameters()])

    def d_loss(self, fake, real, alpha):
        """The discriminators' loss, their mean (0.5 (patch + full) for
        double_gan), as ``get_loss`` computes it."""
        kw = {"alpha": alpha} if alpha is not None else {}
        return sum(self.disc_loss.get_loss(d, fake, real, **kw)
                   for d in self.ds.values()) / len(self.ds)

    def g_loss(self, fake, real):
        adv = sum(self.disc_loss.get_g_loss(d, fake, real) for d in self.ds.values()) / len(self.ds)
        return self.content(fake, real) + self.cfg["adv_lambda"] * adv

    def step(self, blurred, sharp, alpha=None, timed=False):
        """One alternation: G's forward; D on the detached fake (for WGAN-GP
        the Wasserstein terms, then the penalty, then their backward, timed
        apart); D's Adam step; G on content + adv_lambda * adversarial
        against the updated Ds; G's Adam step. Returns the losses, the
        gradients, the D weights after D's step, and with ``timed`` the ms
        of each part (CUDA events; the copies the checks keep are left out)
        and the peak memory."""
        import torch

        marks = {}

        def mark(name):
            if timed:
                marks[name] = torch.cuda.Event(enable_timing=True)
                marks[name].record()

        if timed:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        mark("start")
        fake = self.g(blurred)
        mark("g_forward")
        self.d_opt.zero_grad(set_to_none=True)
        detached = fake.detach()
        if self.cfg["disc_loss"] == "wgan-gp":
            wass = [d(detached).mean() - d(sharp).mean() for d in self.ds.values()]
            mark("d_forward")
            pen = [self.disc_loss.calc_gradient_penalty(d, sharp, detached, alpha=alpha)
                   for d in self.ds.values()]
            mark("penalty")
            loss_d = sum(w + p for w, p in zip(wass, pen)) / len(self.ds)
        else:
            loss_d = self.d_loss(detached, sharp, alpha)
            mark("d_forward")
            mark("penalty")
        loss_d.backward()
        mark("d_backward")
        d_grads = {k: grads_of(d) for k, d in self.ds.items()}
        mark("d_copied")
        self.d_opt.step()
        mark("d_optimizer")
        d_after = {k: weights_of(d) for k, d in self.ds.items()}
        mark("g_start")
        self.g_opt.zero_grad(set_to_none=True)
        loss_g = self.g_loss(fake, sharp)
        loss_g.backward()
        mark("g_backward")
        g_grads = grads_of(self.g)
        mark("g_copied")
        self.g_opt.step()
        mark("g_optimizer")
        rec = {"loss_d": float(loss_d.detach()), "loss_g": float(loss_g.detach()),
               "d_grads": d_grads, "g_grads": g_grads, "d_after": d_after,
               "fake": fake.detach()}
        if timed:
            marks["g_optimizer"].synchronize()

            def ms(a, b):
                return marks[a].elapsed_time(marks[b])

            rec["ms"] = {"g_forward": ms("start", "g_forward"),
                         "d_forward": ms("g_forward", "d_forward"),
                         "penalty": ms("d_forward", "penalty"),
                         "d_backward": ms("penalty", "d_backward"),
                         "d_optimizer": ms("d_copied", "d_optimizer"),
                         "g_step": (ms("start", "g_forward") + ms("g_start", "g_backward")
                                    + ms("g_copied", "g_optimizer"))}
            rec["ms"]["d_step"] = sum(rec["ms"][k] for k in ("d_forward", "penalty",
                                                             "d_backward", "d_optimizer"))
            rec["ms"]["step"] = rec["ms"]["d_step"] + rec["ms"]["g_step"]
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return rec


def median_ms(steps, key):
    return float(np.median([s["ms"][key] for s in steps]))


def gan_gradient_twin(device, start, vgg_sd, blurred, sharp, first):
    """Phase 20 (a)'s gradients: step 1 again in float64 on the card and on
    the CPU (the CPU's losses through ``get_loss``), every gradient of G and
    of both Ds held to TRAIN_GRAD_RTOL relative L2 a tensor. In float32 the
    bound is out of reach of any two implementations: a random-init
    FPN-Inception's gradients through its per-sample norms differ from
    float64 by up to 1e-2 relative a tensor on the CPU as on the card
    (``python -m tpuir_torch.utils.gan_precision``); so the card's float32
    gradients are printed against the float64 ones, unbounded."""
    import torch

    from tpuir_torch.models.deblurgan import fpn_inception

    f64 = torch.float64
    card = GanRun(RELEASED, device, fpn_inception.FPNInception, start["g"], start["ds"], vgg_sd,
                  f64)
    rec = card.step(blurred.to(f64), sharp.to(f64), start["alpha"])
    cpu = GanRun(RELEASED, torch.device("cpu"), fpn_inception.FPNInception, start["g"],
                 start["ds"], vgg_sd, f64)
    b_cpu, s_cpu = blurred.cpu().to(f64), sharp.cpu().to(f64)
    fake = cpu.g(b_cpu)
    loss_d = cpu.d_loss(fake.detach(), s_cpu, start["alpha"])
    loss_d.backward()
    errs = [check_loss("released recipe step 1 (float64) D loss", rec["loss_d"],
                       float(loss_d.detach()))]
    held, f32 = [], []
    for k, d in cpu.ds.items():
        want = grads_of(d)
        held.append(check_grads(f"released recipe step 1 (float64) D {k}", rec["d_grads"][k], want))
        f32.append(gradient_spread(first["d_grads"][k], want))
        d.load_state_dict(rec["d_after"][k])
        d.zero_grad(set_to_none=True)
    loss_g = cpu.g_loss(fake, s_cpu)
    loss_g.backward()
    errs.append(check_loss("released recipe step 1 (float64) G loss", rec["loss_g"],
                           float(loss_g.detach())))
    want = grads_of(cpu.g)
    held.append(check_grads("released recipe step 1 (float64) G", rec["g_grads"], want))
    f32.append(gradient_spread(first["g_grads"], want))
    names = ("D patch", "D full", "G")
    print("  released recipe step 1 in float64, card against CPU: losses "
          f"{max(errs):.1e} relative; gradients " + ", ".join(
              f"{n} worst {w:.1e} ({k}; {z} zero by construction)"
              for n, (w, k, z) in zip(names, held)) + f" (limit {TRAIN_GRAD_RTOL})", flush=True)
    print("  the card's float32 gradients of step 1 against float64 (no bound): " + ", ".join(
        f"{n} worst {w:.2e} ({k}), {m} of {t} tensors past {TRAIN_GRAD_RTOL}, the whole "
        f"gradient {a:.2e}" for n, (w, k, m, t, a) in zip(names, f32)), flush=True)


def gradient_spread(got, want):
    """(worst relative L2 a tensor, its name, tensors past TRAIN_GRAD_RTOL,
    tensors counted, relative L2 of the whole gradient) of float32
    gradients ``got`` against float64 ``want``, the tensors that are zero by
    construction left out."""
    import torch

    total = float(torch.sqrt(sum((w.double() ** 2).sum() for w in want.values())))
    rows = [(rel_l2(got[k], w), k) for k, w in want.items()
            if float(torch.linalg.vector_norm(w.double())) > GAN_ZERO_SHARE * total]
    whole = float(torch.sqrt(sum(((got[k].double() - w.double()) ** 2).sum()
                                 for k, w in want.items()))) / total
    worst = max(rows)
    return worst[0], worst[1], sum(r > TRAIN_GRAD_RTOL for r, _ in rows), len(rows), whole


def gan_released(device):
    """Phase 20 (a): the released recipe at full width, 5 steps on the card;
    step 1 against the same step on the CPU."""
    import torch

    from tpuir_torch.models.deblurgan import fpn_inception
    from tpuir_torch.models.deblurgan.discriminators import get_discriminator
    from tpuir_torch.train import deblurgan_losses, vgg_features
    from tpuir_torch.utils.misc import seeded_state_dict

    g_sd = fpn_inception.init_state_dict(seed=GAN_SEED)
    d_sds = {k: seeded_state_dict(d, GAN_SEED + 1 + i)
             for i, (k, d) in enumerate(get_discriminator(RELEASED, device="cpu").items())}
    vgg_sd = vgg_features.init_state_dict(seed=GAN_SEED + 5)
    blurred, sharp = gan_pair(device)
    card = GanRun(RELEASED, device, fpn_inception.FPNInception, g_sd, d_sds, vgg_sd)
    alphas = torch.Generator().manual_seed(GAN_SEED)
    steps = []
    for i in range(GAN_STEPS):
        alpha = deblurgan_losses.DiscLossWGANGP.draw_alpha(alphas)
        start = ({"g": weights_of(card.g), "ds": {k: weights_of(d) for k, d in card.ds.items()},
                  "alpha": alpha} if i == 0 else None)
        rec = card.step(blurred, sharp, alpha, timed=True)
        if not (np.isfinite(rec["loss_d"]) and np.isfinite(rec["loss_g"])):
            fail(f"DeblurGANv2 step {i + 1}: a loss is not finite ({rec['loss_d']}, "
                 f"{rec['loss_g']})")
        rec["start"] = start
        steps.append(rec)
        ms = rec["ms"]
        print(f"  released recipe step {i + 1}: D loss {rec['loss_d']:.7e}, G loss "
              f"{rec['loss_g']:.7e}; G forward {ms['g_forward']:.2f} ms, D forward "
              f"{ms['d_forward']:.2f}, penalty {ms['penalty']:.2f}, D backward (the double "
              f"backward) {ms['d_backward']:.2f}, D optimizer {ms['d_optimizer']:.2f}, G step "
              f"{ms['g_step']:.2f}; peak {rec['peak_gb']:.2f} GB", flush=True)
    later = steps[1:]
    print(f"  released recipe, median of steps 2-{GAN_STEPS}: D step "
          f"{median_ms(later, 'd_step'):.2f} ms (forward {median_ms(later, 'd_forward'):.2f}, penalty {median_ms(later, 'penalty'):.2f}"
          f" and its double backward {median_ms(later, 'd_backward'):.2f}, optimizer "
          f"{median_ms(later, 'd_optimizer'):.2f}), G step {median_ms(later, 'g_step'):.2f} ms "
          f"(G forward {median_ms(later, 'g_forward'):.2f}); peak "
          f"{max(s['peak_gb'] for s in later):.2f} GB", flush=True)

    # the CPU twin of step 1 in float32: the same weights, pair and alpha,
    # G's part against the card's updated discriminators: G's output and
    # both losses (forwards only)
    first, cpu_dev = steps[0], torch.device("cpu")
    start = first["start"]
    cpu = GanRun(RELEASED, cpu_dev, fpn_inception.FPNInception, start["g"], start["ds"], vgg_sd)
    b_cpu, s_cpu = blurred.cpu(), sharp.cpu()
    fake = cpu.g(b_cpu)
    out_err = float((fake.detach() - first["fake"].cpu()).abs().max())
    if out_err > GAN_OUT_ATOL:
        fail(f"released recipe step 1: G's output is {out_err:.2e} from the CPU's")
    errs = [check_loss("released recipe step 1 D loss", first["loss_d"],
                       float(cpu.d_loss(fake.detach(), s_cpu, start["alpha"]).detach()))]
    for k, d in cpu.ds.items():
        d.load_state_dict(first["d_after"][k])
    with torch.no_grad():
        errs.append(check_loss("released recipe step 1 G loss", first["loss_g"],
                               float(cpu.g_loss(fake, s_cpu))))
    print(f"  released recipe step 1 against the CPU (float32): G output max|d| {out_err:.2e} "
          f"(limit {GAN_OUT_ATOL}); losses {max(errs):.2e} relative (limit {GAN_LOSS_RTOL})",
          flush=True)
    gan_gradient_twin(device, start, vgg_sd, blurred, sharp, first)
    return steps[-1]["fake"], sharp


def clone_pool(pool, device):
    from tpuir_torch.train.deblurgan_losses import ImagePool

    out = ImagePool(pool.pool_size)
    out.sample_size = pool.sample_size
    out.images.extend(t.to(device) for t in pool.images)
    return out


def gan_relativistic(device):
    """Phase 20 (b): FPN-MobileNet, patch_gan, ragan-ls, 3 steps; each step
    against the CPU started from the card's weights and pools."""
    import random

    import torch

    from tpuir_torch.models.deblurgan import fpn_mobilenet
    from tpuir_torch.models.deblurgan.discriminators import get_discriminator
    from tpuir_torch.utils.misc import seeded_state_dict

    d_sds = {k: seeded_state_dict(d, GAN_SEED + 11)
             for k, d in get_discriminator(RAGAN, device="cpu").items()}
    blurred, sharp = gan_pair(device, GAN_SEED + 12)
    card = GanRun(RAGAN, device, fpn_mobilenet.FPNMobileNet,
                  fpn_mobilenet.init_state_dict(seed=GAN_SEED + 13), d_sds, None)
    cpu_dev, errs, times = torch.device("cpu"), [], []
    for i in range(RAGAN_STEPS):
        start = (weights_of(card.g), {k: weights_of(d) for k, d in card.ds.items()},
                 clone_pool(card.disc_loss.fake_pool, cpu_dev),
                 clone_pool(card.disc_loss.real_pool, cpu_dev))
        pooled = len(card.disc_loss.fake_pool.images)
        rec = card.step(blurred, sharp, timed=True)
        times.append(rec["ms"]["step"])
        cpu = GanRun(RAGAN, cpu_dev, fpn_mobilenet.FPNMobileNet, start[0], start[1], None)
        cpu.disc_loss.fake_pool, cpu.disc_loss.real_pool = start[2], start[3]
        fake = cpu.g(blurred.cpu())
        loss_d = cpu.d_loss(fake.detach(), sharp.cpu(), None)
        if [len(p.images) for p in (card.disc_loss.fake_pool, card.disc_loss.real_pool)] != [
                len(p.images) for p in (cpu.disc_loss.fake_pool, cpu.disc_loss.real_pool)]:
            fail(f"ragan-ls step {i + 1}: the card's pools hold other counts than the CPU's")
        for name, got, want in zip(("fake", "real"), card.disc_loss.pool_means(),
                                   cpu.disc_loss.pool_means()):
            errs.append(check_loss(f"ragan-ls step {i + 1} {name} pool mean", float(got),
                                   float(want)))
        for k, d in cpu.ds.items():
            d.load_state_dict(rec["d_after"][k])
        loss_g = cpu.g_loss(fake, sharp.cpu())
        errs.append(check_loss(f"ragan-ls step {i + 1} D loss", rec["loss_d"],
                               float(loss_d.detach())))
        errs.append(check_loss(f"ragan-ls step {i + 1} G loss", rec["loss_g"],
                               float(loss_g.detach())))
        print(f"  ragan-ls step {i + 1}: D loss {rec['loss_d']:.7e}, G loss "
              f"{rec['loss_g']:.7e} (pools held {pooled} earlier predictions); step "
              f"{times[-1]:.2f} ms; peak {rec['peak_gb']:.2f} GB", flush=True)
    # the pools' draws under one random seed: the card's and a CPU copy's
    draws = []
    for pool in (card.disc_loss.fake_pool, clone_pool(card.disc_loss.fake_pool, cpu_dev)):
        pool.sample_size = len(pool.images) - 1
        random.seed(GAN_SEED)
        draws.append(pool.query().cpu())
    if not torch.equal(draws[0], draws[1]):
        fail("ragan-ls: the card's pool draws are not the CPU's under one random seed")
    print(f"  ragan-ls against the CPU from the card's weights and pools: losses and the pools' "
          f"means within "
          f"{max(errs):.2e} relative (limit {GAN_LOSS_RTOL}); the pools' random.sample draws "
          f"the CPU's; median step {float(np.median(times[1:])):.2f} ms", flush=True)


GENERATORS = [("ResnetGenerator (ngf 64, 6 blocks)", "resnet_gen"),
              ("FPN-Inception-Simple", "fpn_inception_simple"), ("FPN-Dense", "fpn_densenet"),
              ("UNet-SEResNeXt", "unet_seresnext")]


def gan_generators(device, blurred, sharp):
    """Phase 20 (c): the four extra generators at full width, one L1 step
    (forward and backward) each: the card's float32 output against the
    CPU's, the gradients in float64 on both (as ``gan_gradient_twin``)."""
    import importlib

    import torch

    for label, name in GENERATORS:
        mod = importlib.import_module(f"tpuir_torch.models.deblurgan.{name}")
        sd = mod.init_state_dict(seed=GAN_SEED + 20)
        runs = []  # the card in float32 twice, then float64 on the card and on the CPU
        for dev, dtype in ((device, None), (device, None), (device, torch.float64),
                           (torch.device("cpu"), torch.float64)):
            net = mod.build(sd, device=dev).train()
            timed = dtype is None
            if timed:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
            else:
                net.to(dtype)
            x, y = blurred.to(dev), sharp.to(dev)
            out = net(x if timed else x.to(dtype))
            if timed:
                ev[1].record()
            torch.mean(torch.abs(out - (y if timed else y.to(dtype)))).backward()
            if timed:
                ev[2].record()
                ev[2].synchronize()
            runs.append((out.detach().cpu(), grads_of(net),
                         (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])) if timed else None,
                         torch.cuda.max_memory_allocated() / 1e9 if timed else None))
        with torch.no_grad():
            want = mod.build(sd, device="cpu").train()(blurred.cpu())
        (out1, g1, _, _), (out2, g2, ms, peak), (_, g64, _, _), (_, w64, _, _) = runs
        repeat = (torch.equal(out1, out2), all(torch.equal(g1[k], g2[k]) for k in g1))
        err = float((out2 - want).abs().max())
        if err > GAN_OUT_ATOL:
            fail(f"{label}: output {err:.2e} from the CPU's")
        worst, key, zeros = check_grads(f"{label} (float64)", g64, w64)
        w32, k32, past, count, whole = gradient_spread(g2, w64)
        print(f"  {label} at {GAN_SIDE}x{GAN_SIDE}, batch 1: forward {ms[0]:.2f} ms, L1 backward "
              f"{ms[1]:.2f} ms, peak {peak:.2f} GB; output max|d| {err:.2e} from the CPU "
              f"(float32); gradients in float64 worst {worst:.1e} from the CPU's ({key}; {zeros} "
              f"zero by construction); float32 against float64 (no bound): worst {w32:.2e} "
              f"({k32}), {past} of {count} tensors past {TRAIN_GRAD_RTOL}, the whole gradient "
              f"{whole:.2e}; float32 repeats bit for bit: output {repeat[0]}, gradients "
              f"{repeat[1]}", flush=True)


def gan_multi_scale(device, fake, sharp):
    """Phase 20 (d): one D step of the multi-scale discriminator with
    ``train/losses.multi_scale_gan_loss`` (lsgan) on the card and on the
    CPU: the float32 loss, and the loss and gradients in float64 (as
    ``gan_gradient_twin``)."""
    import torch

    from tpuir_torch.models.deblurgan.discriminators import get_discriminator
    from tpuir_torch.train.losses import multi_scale_gan_loss
    from tpuir_torch.train.trainer import build_optimizer
    from tpuir_torch.utils.misc import seeded_state_dict

    cfg = {"d_name": "multi_scale", "norm_layer": "instance"}
    sd = seeded_state_dict(get_discriminator(cfg, device="cpu")["multi_scale"], GAN_SEED + 30)
    res = {}
    for dtype in (torch.float32, torch.float64):
        for dev in (device, torch.device("cpu")):  # the card, then the CPU
            d = get_discriminator(cfg, device=dev)["multi_scale"]
            d.load_state_dict(sd)
            d.to(dtype)
            opt = build_optimizer({"type": "Adam", "lr": GAN_LR}, list(d.parameters()))
            opt.zero_grad(set_to_none=True)
            loss = 0.5 * (
                multi_scale_gan_loss(d(fake.to(dev, dtype)), False, "lsgan", is_disc=True)
                + multi_scale_gan_loss(d(sharp.to(dev, dtype)), True, "lsgan", is_disc=True))
            loss.backward()
            res.setdefault(dtype, []).append((float(loss.detach()), grads_of(d)))
            opt.step()
    (l32, _), (w32, _) = res[torch.float32]
    (l64, g64), (w64, want) = res[torch.float64]
    err = check_loss("multi_scale D loss", l32, w32)
    err64 = check_loss("multi_scale D loss (float64)", l64, w64)
    worst, key, zeros = check_grads("multi_scale D (float64)", g64, want)
    print(f"  multi_scale (lsgan) D step: loss {l32:.7e}, {err:.2e} relative from the CPU; in "
          f"float64 the loss {err64:.1e} and the gradients worst {worst:.1e} from the CPU's "
          f"({key}; {zeros} zero by construction)", flush=True)


def gan_metrics(device, fake, sharp):
    """Phase 20 (e): FID Inception features of 4 seeded 299x299 images on
    the card and the CPU, and DeblurGANv2's SSIM on the card against the
    CPU. The FID of the two feature sets (a 2048x2048 ``sqrtm`` on the
    host, about 15 s) starts in a thread; returns the function that waits
    for it and checks it."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tpuir_torch.train import deblurgan_metrics, extra_metrics, fid_inception

    images = np.random.RandomState(GAN_SEED + 40).rand(FID_IMAGES, FID_SIDE, FID_SIDE, 3)
    images = images.astype(np.float32)
    feats = []
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_fid_") as d:
        path = os.path.join(d, "pt_inception-seeded.pth")  # a seeded checkpoint, read back
        torch.save(fid_inception.init_state_dict(seed=GAN_SEED + 41), path)
        for dev in (device, torch.device("cpu")):
            net = fid_inception.load_patched_inception_v3(path, device=dev)
            feats.append(fid_inception.extract_inception_features(
                iter([images[:2], images[2:]]), net))
    err = float(np.abs(feats[0] - feats[1]).max())
    if err > FID_ATOL:
        fail(f"FID Inception features: {err:.2e} from the CPU's")
    pool = ThreadPoolExecutor(1)
    fid_of = pool.submit(extra_metrics.calculate_fid_from_stats,
                         *extra_metrics.feature_stats(feats[0]),
                         *extra_metrics.feature_stats(feats[1]))
    pool.shutdown(wait=False)
    a, b = (fake + 1) / 2, (sharp + 1) / 2
    got = float(deblurgan_metrics.ssim(a, b))
    want = float(deblurgan_metrics.ssim(a.cpu(), b.cpu()))
    if not abs(got - want) <= SSIM_ATOL:
        fail(f"DeblurGANv2 SSIM: {got} on the card, {want} on the CPU")
    p, s, vis = deblurgan_metrics.get_images_and_metrics(fake, fake, sharp)
    print(f"  FID Inception ({FID_IMAGES} images {FID_SIDE}x{FID_SIDE}): features max|d| "
          f"{err:.2e} from the CPU; SSIM {got:.7f} on the card, {abs(got - want):.1e} from the "
          f"CPU; PSNR {p:.3f} dB, SSIM (uint8) {s:.4f} of the last fake", flush=True)

    def finish():
        fid = fid_of.result()
        if not abs(fid) < FID_ZERO:
            fail(f"FID of the card's features against the CPU's: {fid}")
        print(f"  phase 20 (e): FID(card's features, CPU's) {fid:.3e} (limit {FID_ZERO})",
              flush=True)

    return finish


def phase_deblurgan_training(device):
    """Phase 20: DeblurGANv2 training on the card, float32 with TF32 off,
    seeded weights, seeded synthetic pairs. No kernel is on this path.
    Returns (e)'s function that waits for the FID and checks it."""
    from tpuir_torch.core.engine import true_float32
    from tpuir_torch.ops import _kernels

    _kernels.reset_launches()
    with true_float32():
        t0 = time.time()
        fake, sharp = gan_released(device)
        print(f"[20a released recipe {time.time() - t0:.0f} s]", flush=True)
        t0 = time.time()
        gan_relativistic(device)
        print(f"[20b ragan-ls pools {time.time() - t0:.0f} s]", flush=True)
        t0 = time.time()
        gan_generators(device, *gan_pair(device, GAN_SEED + 50))
        print(f"[20c extra generators {time.time() - t0:.0f} s]", flush=True)
        t0 = time.time()
        gan_multi_scale(device, fake, sharp)
        print(f"[20d multi_scale {time.time() - t0:.0f} s]", flush=True)
        t0 = time.time()
        finish_fid = gan_metrics(device, fake, sharp)
        print(f"[20e FID features and SSIM {time.time() - t0:.0f} s]", flush=True)
    if any(_kernels.LAUNCHES.values()):
        fail(f"DeblurGANv2 training launched kernels: {_kernels.LAUNCHES}")
    return finish_fid


# -- phase 21: data parallelism ----------------------------------------------

# phase 18's requests (``utils.profiling.ENGINE_REQUESTS``: Restormer 512x512,
# MaIR-CDN 256x256, sigma=25) on its seeded checkpoints; its batch-8 cells'
# outputs and ms are the single-device reference
PARALLEL_CELLS = (("restormer", "parity"), ("mair", "parity"), ("restormer", "serving"),
                  ("mair", "serving"))
PARALLEL_LABELS = {"restormer": "Restormer", "mair": "MaIR-CDN"}
PARALLEL_BATCH = 8  # the zoo's batch, phase 18's batch-8 cells'
PARALLEL_LSB = 1  # a world of two against the single-device engine
DDP_DEPTHS = (6,)  # MaIR-CDN cut to one residual group of six layers (phase 19: 6 x 6)
DDP_STEPS = 2
PARALLEL_THREADS = 4  # torch's CPU threads in each of the two ranks
PARALLEL_TIMEOUT_S = 300  # the world of two's limit: spawn, builds, serving, steps


def parallel_cells(engine_outs, wdir):
    """Phase 21's cells, their seeded checkpoints (phase 18's) written under
    ``wdir``: label, the zoo call a rank builds its model with, request
    (image, AWGN sigma), phase 18's single-device (output, ms), launches a
    forward chunk, patch size and patches a rank at worlds 1 and 2
    (``engine_outs`` is ``phase_window``'s)."""
    import functools

    from tpuir_torch import zoo
    from tpuir_torch.config import get_patch_config
    from tpuir_torch.utils.profiling import ENGINE_REQUESTS, write_seeded_checkpoint

    cells = []
    for key in dict.fromkeys(key for key, _ in PARALLEL_CELLS):
        write_seeded_checkpoint(key, wdir, seed=SEED)
    for key, precision in PARALLEL_CELLS:
        (task, subtask, name, gray, sigma), _, _ = ENGINE_REQUESTS[key]
        img, noise = window_request(key)
        pc = get_patch_config(task, subtask, name)
        out, ms, per_chunk = engine_outs[(key, precision)]
        cells.append({
            "label": f"{PARALLEL_LABELS[key]} {precision}",
            "build": functools.partial(zoo.get_model_instance, task, subtask, name, gray=gray,
                                       sigma=sigma, weights_dir=wdir, precision=precision),
            "request": (img, noise), "single": (out, ms),
            "per_chunk": per_chunk, "patch": pc["patch_size"],
            "shares": {world: sharded_share(pc["patch_size"], pc["patch_overlap"],
                                            *img.shape[:2], world) for world in (1, 2)}})
    return cells


def sharded_share(patch, overlap, h, w, world) -> int:
    """Patches a rank serves of an h x w request in a world of ``world``
    (the grid padded to a multiple of the world)."""
    from tpuir_torch.core.tiling import tile_indices

    _, hs, ws = tile_indices(h, w, patch, overlap)
    return -(-len(hs) * len(ws) // world)


def ddp_options(device):
    """Phase 21 (c)'s option dict: phase 19's MaIR-CDN and ``train``
    section with the depth cut to ``DDP_DEPTHS`` and mixup off (each rank
    would mix its own share)."""
    from tpuir_torch.train.options import yaml_load

    train = dict(yaml_load(TRAIN_OPTIONS)["train"])
    train["mixing_augs"] = dict(train.get("mixing_augs") or {}, mixup=False)
    net = dict(yaml_load(MAIR_TEST_OPTIONS)["network_g"], depths=list(DDP_DEPTHS))
    return {"model_type": "SRModel", "is_train": True, "manual_seed": 21,
            "device": str(device), "network_g": net, "path": {}, "train": train}


def ddp_batches():
    """``DDP_STEPS`` global batches of ``TRAIN_BATCH`` seeded crops
    (``TRAIN_CROP``), clean and with sigma=25 noise, NHWC float32."""
    rng = np.random.RandomState(2100)
    gt = np.empty((DDP_STEPS, TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3), np.float32)
    for s in range(DDP_STEPS):
        for b in range(TRAIN_BATCH):
            img = synthetic_image(96, 80, 2100 + s * TRAIN_BATCH + b)
            y, x = rng.randint(0, 96 - TRAIN_CROP), rng.randint(0, 80 - TRAIN_CROP)
            gt[s, b] = img[y:y + TRAIN_CROP, x:x + TRAIN_CROP] / 255.0
    lq = (gt + rng.standard_normal(gt.shape) * (SIGMA / 255.0)).astype(np.float32)
    return lq, gt


def check_ddp(label, got, ref):
    """A data-parallel run's steps against the single-process steps
    ``ref`` on the full batch: each step's loss within TRAIN_LOSS_RTOL,
    step 1's gradients within TRAIN_GRAD_RTOL relative L2 a tensor (phase
    19's bounds); the weights after each step printed against ``ref``'s."""
    import torch

    for i in range(DDP_STEPS):
        d = abs(got["loss"][i] - ref["loss"][i]) / abs(ref["loss"][i])
        weights = max(float(np.abs(got["params"][i][k] - v).max())
                      for k, v in ref["params"][i].items())
        line = (f"  {label} step {i + 1}: {got['ms'][i]:.1f} ms (single process "
                f"{ref['ms'][i]:.1f} ms); loss {got['loss'][i]:.7e}, rel diff {d:.2e} "
                f"(limit {TRAIN_LOSS_RTOL:g}); weights after it max|d| {weights:.3e}")
        if i == 0:
            worst = max((rel_l2(torch.from_numpy(got["grads"][0][k]), torch.from_numpy(v)), k)
                        for k, v in ref["grads"][0].items())
            line += (f"; gradients, worst tensor {worst[1]}: rel L2 {worst[0]:.2e} "
                     f"(limit {TRAIN_GRAD_RTOL:g})")
            if worst[0] > TRAIN_GRAD_RTOL:
                fail(f"{label}: step 1's gradient {worst[1]} {worst[0]:.2e} from one process's")
        print(line, flush=True)
        if d > TRAIN_LOSS_RTOL:
            fail(f"{label} step {i + 1}: loss {got['loss'][i]} against one process's "
                 f"{ref['loss'][i]}")


def phase_parallel(device, engine_outs):
    """Phase 21: data parallelism on the one card (see the module
    docstring), against phase 18's single-device outputs ``engine_outs``.
    Returns the launches of its sharded requests and DDP steps, the
    spawned ranks' included."""
    import concurrent.futures

    from tpuir_torch.parallel import jobs
    from tpuir_torch.parallel.dist import destroy_dist, init_dist
    from tpuir_torch.parallel.launch import launch

    opt, (lq, gt) = ddp_options(device), ddp_batches()
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_parallel_") as wdir:
        cells = parallel_cells(engine_outs, wdir)
        gathered = cells[0]  # Restormer parity: the gathers' share, its predictions
        gather_shape = {world: (n, gathered["patch"], gathered["patch"], 3)
                        for world, n in gathered["shares"].items()}
        requests = [[c["request"]] for c in cells]
        builds = [c["build"] for c in cells]

        # the world of two starts now, beside this process's runs below (its
        # spawn, imports, CUDA context and group: host work), and waits for
        # ``go`` before it builds its models and serves; time.time() between
        # its jobs
        go, clock = os.path.join(wdir, "go"), (time.time, ())
        world2_calls = [
            (jobs.wait_for, (go, PARALLEL_TIMEOUT_S)), clock,
            (jobs.serve, (builds, requests, ROUNDS)), clock,
            (jobs.time_gathers, (gather_shape[2],)), clock,
            (jobs.train_steps, (opt, lq, gt)), clock]
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            t_launch = time.time()
            pending = pool.submit(launch, jobs.several, 2, args=(world2_calls,),
                                  backend="gloo", device=str(device),
                                  timeout=PARALLEL_TIMEOUT_S, threads=PARALLEL_THREADS)
            try:
                t0 = time.time()
                ref = jobs.train_steps(opt, lq, gt)  # one process on the full batch
                print(f"  {DDP_STEPS} single-process steps [{time.time() - t0:.0f} s]",
                      flush=True)

                # a world of one on NCCL, in this process
                t0 = time.time()
                with tempfile.TemporaryDirectory(prefix="tpuir_torch_store_") as store:
                    init_dist("nccl", 0, 1, device=device,
                              init_method="file://" + os.path.join(store, "store"))
                    try:
                        world1 = jobs.several([
                            (jobs.serve, (builds, requests, ROUNDS)),
                            (jobs.time_gathers, (gather_shape[1],)),
                            (jobs.train_steps, (opt, lq, gt))])
                    finally:
                        destroy_dist()
                print(f"  world of one on NCCL [{time.time() - t0:.0f} s]", flush=True)
            finally:
                with open(go, "w"):
                    pass
            t_go = time.time()
            world2 = pending.result()
        for rank, r in enumerate(world2):
            print(f"  world of two on gloo, rank {rank}: ready {t_go - t_launch - r[0]:.1f} s "
                  f"after the launch; then serving {r[3] - r[1]:.1f} s (its models built), "
                  f"gathers {r[5] - r[3]:.1f} s, DDP steps {r[7] - r[5]:.1f} s (its model "
                  f"built)", flush=True)
        print(f"  world of two on gloo, one card: {time.time() - t_go:.0f} s after this "
              f"process's runs", flush=True)
        world2 = [r[2::2] for r in world2]

    launches = {}
    for world, ranks in ((1, [world1]), (2, world2)):
        for rank, (served, gathers, steps) in enumerate(ranks):
            want = {}
            for c in cells:
                chunks = -(-c["shares"][world] // PARALLEL_BATCH)
                for k, n in c["per_chunk"].items():
                    want[k] = want.get(k, 0) + n * chunks * ROUNDS
            got = {k: served["launches"][k] for k in want}
            if got != want:
                fail(f"world {world} rank {rank}: sharded launches {got}, expected {want}")
            train_want = dict.fromkeys(("mixer_prologue", "nss_scan", "mixer_epilogue"),
                                       sum(DDP_DEPTHS) * DDP_STEPS)
            train_got = {k: v for k, v in steps["launches"].items() if v}
            if train_got != train_want:
                fail(f"world {world} rank {rank}: DDP launches {train_got}, "
                     f"expected {train_want}")
            for k, n in list(got.items()) + list(train_got.items()):
                launches[k] = launches.get(k, 0) + n
            print(f"  world {world} rank {rank}: launches, sharded requests {got}, "
                  f"DDP steps {train_got}", flush=True)
            for i, c in enumerate(cells):
                out, ms = served["outputs"][i][0], served["ms"][i][0]
                single, single_ms = c["single"]
                lsb = int(np.abs(out.astype(int) - single.astype(int)).max())
                h, w = out.shape[:2]
                print(f"  world {world} rank {rank}: {c['label']} {h}x{w}: sharded {ms:.1f} ms "
                      f"({c['shares'][world]} patches a rank), single device (phase 18) "
                      f"{single_ms:.1f} ms; max|sharded - single| {lsb} LSB", flush=True)
                if world == 1 and lsb:
                    fail(f"{c['label']}: the world of one is not bit-equal to the engine")
                if lsb > PARALLEL_LSB:
                    fail(f"{c['label']}: the world of two differs by {lsb} LSB from the engine")
                if rank and not np.array_equal(out, world2[0][0]["outputs"][i][0]):
                    fail(f"{c['label']}: the ranks of the world of two return other images")
            print(f"  world {world} rank {rank}: gather of the Restormer 512x512 request's "
                  f"predictions ({gather_shape[world]} float32 a rank), median ms: "
                  + ", ".join(f"{r} {ms:.3f} ms" for r, ms in gathers.items()), flush=True)
            check_ddp(f"DDP world {world} rank {rank}", steps, ref)
            if rank:
                for i in range(DDP_STEPS):
                    for k, v in steps["params"][i].items():
                        if not np.array_equal(v, world2[0][2]["params"][i][k]):
                            fail(f"DDP: the two ranks hold other weights after step {i + 1}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "tpuir_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository (tpuir_torch/ missing)",
              file=sys.stderr)
        return 1
    from tpuir_torch.ops import _kernels

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    t0 = time.time()
    so = _kernels.build()
    _kernels.library()
    print(f"kernels built in {time.time() - t0:.1f} s: {os.path.relpath(so, root)}", flush=True)
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # the serving checks' planted copies, built at nice 19 while the card
    # runs phases 2-11 (phases 12-15 then only check them)
    from tpuir_torch.utils.serving_mutants import Prebuilt

    threads = torch.get_num_threads()
    with tempfile.TemporaryDirectory(prefix="tpuir_serving_mutants_") as mutant_dir:
        prebuilt = Prebuilt(("K1", "mixer", "seq", "recur"), mutant_dir, jobs=MUTANT_BUILD_JOBS)
        torch.set_num_threads(min(threads, MUTANT_BUILD_THREADS))
        try:
            run_phases(torch.device("cuda", 0), card, prebuilt, threads)
        finally:
            prebuilt.close()
    return 0


def run_phases(device, card, prebuilt, threads) -> None:
    """Phases 2-21 on ``device``, then the kernels line and the last line;
    torch's CPU threads back to ``threads`` from phase 12 on."""
    import torch

    from tpuir_torch import zoo

    t0 = time.time()
    k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by, k1_tc = phase_kernel_vs_plain(device)
    print(f"K1 per forward (44 BiasFree blocks, batch {BATCH}): kernel {k1_ms:.2f} ms, "
          f"plain {k1_plain_ms:.2f} ms, bound {k1_bound:.2f} ms ({k1_by}), 3xTF32 bound "
          f"{k1_tc:.2f} ms; max|d| {k1_err:.3e}  [{time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    launches, _, restormer_outs = phase_main_path(device)
    print(f"[Restormer path {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    rows = {"fused_transformer_block": (k1_err, k1_ms, k1_plain_ms, k1_bound, k1_by)}
    rows.update(phase_mair_kernels(device))
    cfg = zoo.MAIR_CDN_CONFIG
    px, dm, di = BATCH * MAIR_TILE ** 2, cfg["embed_dim"], int(cfg["ssm_ratio"] * cfg["embed_dim"])
    nbytes, flops = prologue_work(px, dm, di)
    ebytes, eflops = epilogue_work(px, di, dm, BATCH)
    bounds_tc = {"fused_transformer_block": k1_tc,  # per forward, K6 and K7 per call at CDN@128
                 "mixer_prologue": bound_tc(nbytes, px * 4 * dm * di, flops),
                 "mixer_epilogue": bound_tc(ebytes, px * 2 * di * dm, eflops)}
    print(f"[MaIR kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    mair_launches, _, mair_outs = phase_mair_path(device)
    launches.update(mair_launches)
    print(f"[MaIR path {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    unet_worst, _, k3_row, k3_updates = phase_unet_kernels(device)
    rows["selective_scan_fused_proj"] = k3_row
    for name, err in unet_worst.items():
        rows[name] = (max(rows[name][0], err),) + rows[name][1:]
    print(f"[MaIRUNet kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    unet_launches, _, unet_outs = phase_unet_path(device)
    for name, n in unet_launches.items():
        launches[name] = launches.get(name, 0) + n
    print(f"[MaIRUNet path {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    rows["nss_scan_fused"] = phase_fused_kernels(device)
    print(f"[K5 {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for name, n in phase_fused_path(device, mair_outs, unet_outs).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[fused route {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    launches["selective_scan"], rows["selective_scan"] = phase_selective_scan(device)
    print(f"[K4 {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    from tpuir_torch.utils.micro_rate import cdn_scan_updates

    cdn = cdn_scan_updates()  # K4's first case has MaIR-CDN@128's shape
    scan_ms = {"K2": (rows["nss_scan"][1], cdn, 2), "K5": (rows["nss_scan_fused"][1], cdn, 2),
               "K4 at MaIR-CDN's shape": (rows["selective_scan"][1], cdn, 2),
               "K3 per 481x321 chunk": (rows["selective_scan_fused_proj"][1], k3_updates, 1)}
    launches["rate_probe"], rows["rate_probe"] = phase_probe(device, scan_ms)
    print(f"[P1 {time.time() - t0:.0f} s]", flush=True)
    torch.set_num_threads(threads)
    t0 = time.time()
    row = phase_serving_kernels(device, prebuilt=prebuilt)
    rows["fused_transformer_block_serving"] = row
    print(f"K1 serving per forward (44 BiasFree blocks, batch {BATCH}): kernel {row[1]:.2f} ms "
          f"(the replaced body, recorded on an H100 at 700 W: "
          f"{K1_SERVING_REPLACED_MS['forward']:.3f} ms), plain {row[2]:.2f} ms, "
          f"bound {row[3]:.2f} ms ({row[4]}); max|d| {row[0]:.3e}", flush=True)
    launches.update(phase_serving_path(device, restormer_outs))
    print(f"[serving {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    rows.update(phase_mair_serving_kernels(device))
    print(f"[MaIR serving kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    launches.update(phase_mair_serving_path(device, mair_outs))
    print(f"[MaIR serving path {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    seq_rows, mixer_worst = phase_seq_serving_kernels(device)
    rows.update(seq_rows)
    for name, err in mixer_worst.items():
        rows[name] = (max(rows[name][0], err),) + rows[name][1:]
    print(f"[MaIRUNet and off-stripe serving kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for name, n in phase_seq_serving_path(device, unet_outs, mair_outs).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[MaIRUNet and off-stripe serving paths {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    rows["nss_scan_recur_serving"] = phase_recur_kernels(device)
    print(f"[recur kernels {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for name, n in phase_recur_path(device).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[recur paths {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for name, n in phase_harness(device).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[harness {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    phase_plain_conv(device)
    print(f"[plain-conv families {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    window_launches, engine_outs = phase_window(device)
    for name, n in list(window_launches.items()) + list(phase_entry_points(device).items()):
        launches[name] = launches.get(name, 0) + n
    print(f"[window, split and entry points {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for name, n in phase_training(device).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[training {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    finish_fid = phase_deblurgan_training(device)
    print(f"[DeblurGANv2 training {time.time() - t0:.0f} s]", flush=True)
    t0 = time.time()
    for bodies, jobs in DEFERRED_MUTANTS:
        mutant_controls(bodies, jobs, prebuilt)
    finish_fid()
    print(f"[the MaIR serving bodies' mutation controls, and the FID {time.time() - t0:.0f} s]",
          flush=True)
    t0 = time.time()
    for name, n in phase_parallel(device, engine_outs).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[data parallelism {time.time() - t0:.0f} s]", flush=True)

    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches[name], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        **({"bound_tc_ms": bounds_tc[name]} if name in bounds_tc else {}),
    } for name, (err, ms, plain_ms, b_ms, b_by) in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
