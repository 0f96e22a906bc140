#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (`nvcc`):

    python3 chip_smoke.py

It imports torch, numpy and `repro_torch` only.  Inputs come from
`np.random.default_rng(SEED)` with the paper's phi-generator (phi = 0.5).
Any mismatch or exception ends the run with a non-zero exit; no phase's
failure is caught.

1. Build the ten CUDA sources of `src/repro_torch/kernels/csrc`, one
   `nvcc` each, all at once, and print ptxas's registers and spills for
   every compiled tile of the six GEMM kernels and every compiled (type,
   head dim) of the attention kernel, with the path it takes (bf16: the
   TMA ring and warp-specialised wgmma kernel; f32: the SIMT kernel).
   Fails if ptxas serialized any wgmma instructions (its C7512 warning),
   if a bf16 attention kernel spills, or if either e4m3 kernel, either
   int8 product kernel or the real megakernel spills at its default tile
   (in any of that tile's compiled variants).
2. Hold each kernel against its plain PyTorch version on the card, bitwise
   (`same_bits`: floating outputs through their integer views, so a zero's
   sign counts) except attention: the chain scale -> cast (rows and columns, S = 1 or 2)
   -> product (with and without carry) -> Garner (f32 and double-single) at
   a ragged (257, 1000, 129) and at the main path's 4096^3 (N = 8 real,
   N = 14 complex).  Times each kernel and its plain version at the main
   path's shapes with CUDA events; for the two GEMM kernels also
   `torch._int_mm` over the same int8 planes, a product-only yardstick.
   The two megakernels (`fused_mod_gemm`, `fused_karatsuba`) likewise: at
   the ragged shape with chunk_limit = 256 (in-kernel K-chunk reductions),
   f32 and double-single output, raw and prepared B; at 4096^3 (real N = 8
   f32, complex N = 14 double-single) timed, with the 4-launch kernel
   composition of the same GEMM timed beside as the yardstick and held
   bitwise equal to the megakernel.
   The two e4m3 kernels (`fp8_mod_gemm`, `fp8_karatsuba`) against their
   plain versions and against the int8 kernels on the same planes, with
   and without carry: at the ragged shape and at 4096^3 (the chain's
   planes; timed, with `torch._scaled_mm` over the same 4N or 12N e4m3
   digit products as a product-only yardstick), and at the accumulation
   worst case m = n = 128, k = FP8_K_CHUNK_LIMIT = 2^16: planes of -120
   (the largest digits in every product), of alternating signs, and
   random; for the complex kernel AR = -120, AI = 0.
   The four kernels on wgmma with a TMA load path (`fp8_karatsuba`,
   `fp8_mod_gemm`, `karatsuba_fused`, `int8_mod_gemm`) on both of their
   load paths, every tile, with and without carry, against their plain
   versions (the e4m3 ones also against the int8 kernels): RAGGED at N =
   7, 14 and 21 (real: 8, 16, 21; k and n off multiples of 16: the
   kernel's own threads load from global memory), DEEP_RAGGED (129, 4000,
   129) at N = 14 (real: 8; global loads through more than two turns of
   every ring) and ALIGNED_RAGGED (257, 1024, 144) at N = 14 (real: 8;
   TMA, ragged edges), the real ones also on views 1 byte into their
   storage (global loads, byte by byte); the wrappers' `tma_launches`
   beside `launches` must show RAGGED, DEEP_RAGGED and the offset views
   took no TMA launch and ALIGNED_RAGGED only TMA launches.  At the main
   path's size the int8 real kernel is also timed on its global-load path,
   at n - 4 (`global_ms`).
   Both int8 kernels also at their k bound, k = INT8_K_LIMIT = 2^17 (m = n
   = 128, N = 8, every tile, with and without carry): planes of -127 (the
   int32 sums reach 127^2 k), for the Karatsuba one also F operands at
   +-127, for the real one also every residue at its largest magnitude,
   (p - 1) / 2 against -(p - 1) / 2.
   The Garner reconstruction against its plain version at S = 1 and 2, N
   = 1-21, to f32 and double-single, at n = 131 (its scalar path), 256
   and 260 (its vector path), on residues 1 byte into their storage, and
   on bytes over the whole int8 range.  The e4m3 kernels' thread-block
   clusters and the most clusters the card holds at once, per tile and N,
   as for the megakernels.
   The residue cast against its plain version on both scale axes, S = 1
   and 2 and a 2-D input, n_limbs 1-4 (N = 2, 8, 14, 20), at a ragged odd
   k (its scalar path) and a k that is a multiple of 4 (its vector path),
   on inputs and scale vectors 4 bytes into their storage and an input 16
   bytes in; moduli outside odd 5..255 refused by the wrapper and by the C
   entry.  At the main path's shape both of its casts are timed (A's row
   scales as `ms`, B's column scales as `cols_ms`).
   Every compiled tile of the six GEMM kernels (`kernels.common.
   COMPILED_TILES`) against the plain version at the ragged shape: the
   product kernels with and without carry, the megakernels with raw and
   prepared B, f32 and double-single output, chunk_limit 256 and 2^17
   (the real megakernel at N = 8, 16 and 21, the complex one at N = 7, 14
   and 21: their NMAX 8, 16 and 24 instantiations, 21 being the most
   moduli a CRT context takes; each also against the 4-launch
   composition); and at 4096^3 each non-default tile against the default
   tile's output, bitwise, timed (CUDA events).  Both megakernels'
   thread-block clusters and the most clusters the card holds at once, per
   tile and N; the run fails if one does not fit.
   The launch-timing copy kernel (`launch_copy`) against `x.clone()` on an
   (8, 128) f32 tile and at COPY_SIZES elements, each also on a view
   4 bytes into its storage (the kernel's misaligned path), bitwise;
   timed by CUDA events with the stream held
   busy while the host enqueues (the device's time per launch), by CUDA
   events paced by the host, by host wall time through its wrapper (what
   the calibration measures), and `x.clone()` beside it (the library call
   that computes the same function).
   The attention kernel (`flash_attention`) against `flash_attention_plain`
   in the working type (the kernel sums in another order and rounds P to
   bf16 for the PV product): f32 within 2e-5, the reference test's
   tolerance; bf16 elementwise within 2^-7 |plain| (both roundings to bf16)
   plus 2e-2 times the RMS of the plain output's row (`attention_row_err`),
   and the plain version with P rounded to e4m3 must break that limit at
   every shape (`tools/attention_check.py` has the readings over seeds):
   the CPU tests' sweep (2,256,4,2,64), (1,512,8,1,32),
   (2,128,4,4,64), a ragged s = 200, Sk = 256 != S = 128, and two batches
   of two at Qwen's head dim with a ragged tail (ATTN_BATCH_EDGES:
   (2,200,8,2,128), and (2,128,8,2,128) with Sk = 200, where a TMA box
   that crossed a batch would read the next batch's rows), each in f32 and
   bf16, causal and not; every compiled head dim at (1,320,8,2,D) with
   blocks of 64; and Qwen2.5-32B's widths (H = 40, KV = 8, D = 128, B = 1)
   causal, in f32 at S = ATTN_F32_S = 4096 and in bf16 at one 32k prefill
   (ATTN_FULL).  Both full-width shapes are timed with CUDA events beside
   the plain version; at 32k also `torch.nn.functional.
   scaled_dot_product_attention` (is_causal, enable_gqa) on the (B,H,S,D)
   views, the library call computing the same function, with its default
   backend (its max difference from the kernel is printed for information;
   the port never calls it).
3. End to end through `repro_torch.linalg`:
   (a) s/d/c/zgemm at 512^3, fast and accu, on `GemmPolicy(execution=
       "kernel")`, `execution="fused"` and `execution="fp8"` (complex also
       `block_a` and `block_b`), on `execution="reference"` (every complex
       formulation, each CRT method `paper`, `dd` and `garner`) and on
       `execution="per_modulus_kernel"` (complex `karatsuba` and
       `block_a`): bitwise equal to the same call with device="cpu", which
       runs the plain versions (the reference execution is plain PyTorch
       on either device);
   (b) the kernel main path: s/d/c/zgemm at 4096^3 and zgemm at 8192^3,
       fast mode, `execution="kernel"`.  The launch counters are zeroed
       just before and read just after: each GEMM is exactly 4 launches
       (cast, cast, product, reconstruct), which is also what the port's
       `perfmodel.kernel_launch_count` says.  Times beside native
       `torch.matmul` in the same dtype (cuBLAS); relative error
       max|C - C_ref| / max|C_ref| against torch.matmul in
       float64/complex128 on the same operands must stay below 1e-4 (the
       kernel path is f32-grade by design; phase 3(a) is the exactness
       check);
   (c) the fused main path: the same GEMMs on the same operands with
       `execution="fused"`, counters zeroed before and read after: exactly
       1 megakernel launch per GEMM, bitwise equal to (b)'s output, timed
       beside (b) and cuBLAS, relative error below 1e-4.  After its counts
       are read, sgemm at 512^3 and 1024^3 (LAUNCH_BOUND_SIZES), where one
       launch against four should tell, on `fused` and on `kernel` in
       turns, bitwise equal, timed;
   (d) the fp8 main path: the same GEMMs on the same operands with
       `execution="fp8"`, counters zeroed before and read after: exactly 4
       launches per GEMM (cast, cast, one e4m3 product, Garner), bitwise
       equal to (b)'s output, timed beside (b) and cuBLAS, relative error
       below 1e-4;
   (e) the reference execution: (b)'s 4096^3 GEMMs on the same operands
       with `execution="reference"`, fast, default method ('paper'),
       counters zeroed before and read after: no kernel launch.  sgemm and
       cgemm bitwise equal to (b)'s output (the reference holds this at
       f32 grade); dgemm and zgemm within `core.accuracy.rel_bound` for
       their routine, mode and N, measured by `core.accuracy.rel_error`
       against numpy's extended-precision (longdouble) product of
       REF_ROWS evenly spaced rows.  Timed beside (b) and cuBLAS;
   (f) the per-modulus execution: the same GEMMs with
       `execution="per_modulus_kernel"`, counters zeroed before and read
       after: one product launch per modulus on a grid of one plane, the
       casts and reconstructions unstacked, 11 / 19 / 13 / 20 launches
       (`kernel_launch_count(modulus_batched=False)`), every product by
       TMA, bitwise equal to (b)'s output, timed.  Then sgemm (N = 8) and
       zgemm (N = 14) at RAGGED, where the one-plane views and k leave
       TMA (no launch by TMA), and at ALIGNED_RAGGED (every launch by
       TMA), each bitwise equal to `kernel`;
   (g) the backward: sgemm and zgemm at 4096^3 on `kernel` with
       requires_grad on both operands and `backward(g)`: exactly 12
       launches (three GEMMs of four), x.grad and w.grad bitwise equal to
       the forward calls on (g, w^T) and (x^T, g) (for zgemm w^H and
       x^H, `torch.matmul`'s rule), forward + backward timed beside the
       forward; at 512^3 also on `reference` and `fused`, y and both
       gradients bitwise equal to device="cpu".
4. Prepared serving: `prepare_weights({"w": W})` of an 8192 x 8192 W
   (complex128 and float32) on `fused` and on `kernel`, then three requests
   of m = 128, 1024 and 8192 rows each, and on `fp8` one request of m =
   1024: a fused request is 1 launch, a kernel or fp8 request 3 (cast,
   product, Garner; `kernel_launch_count(prepared=True)`), each bitwise
   equal to the unprepared call of the same execution.  Prints each
   request's time.
5. Tuning: the port's `python -m repro_torch.tune` main in full mode (not
   smoke) writes a calibration to a temporary file, the launch counters
   zeroed just before and read just after (the copy kernel: 1 warm-up + 3
   timed launches); prints the measured HW beside the GH200 preset and the
   tuned tiles.  Then `GemmPolicy(calibration=path)` runs phase 3's
   s/d/c/zgemm at 4096^3 on `kernel`, `fused` and `fp8`: each bitwise
   equal to phase 3's uncalibrated output, with the launch counts of
   `kernel_launch_count`, timed beside the uncalibrated run.  Prints the
   plans `formulation="auto"` and `rtol=1e-6` / `mode="auto"` resolve to
   for zgemm 4096^3 under the calibration and under the preset.
6. Attention prefill: `repro_torch.kernels.flash_attention.flash_attention`
   on phase 2's full-width bf16 inputs (one causal 32k prefill at
   Qwen2.5-32B's widths), called 1 + 3 times with the launch counters zeroed
   just before and read just after: exactly one `flash_attention` launch a
   call and no other kernel; each output bitwise equal to the one phase 2
   held against the plain version.  Prints the ms a call and the TFLOP/s
   over the causal half's 2 D H S^2 flop.

7. Model serving (`repro_torch.models`, `repro_torch.serve`):
   (a) all ten archs, reduced, float32, weights from the port's init
       (torch.Generator seed 0, drawn on the CPU and moved): every linear
       of layer 0 of each kind of layer (attention, SSD, RG-LRU, dense
       and MoE MLPs, the shared expert) under `GemmPolicy(backend=
       "ozaki2_f32", execution="kernel")` on the card bitwise equal to
       device="cpu"; a prefill of 32 tokens and 4 greedy steps on
       `kernel`, the logits within SERVE_CARD_TOL (1e-4 x max|logits|) of
       device="cpu" (2e-3 for recurrentgemma-2b, whose float32 RG-LRU
       gates cancel near a = 1: SERVE_CARD_TOL_OF) and the tokens equal
       wherever the cpu's top-2 margin exceeds twice that; for the MoE archs under the routing rule
       (`route_flip`: a token the two runs route to other experts must lie
       within ROUTE_MARGIN of a tie, its row is compared up to it, and at
       most 1 % of the routed tokens may be excluded so);
   (b) starcoder2-3b as published (`configs/starcoder2_3b.py`: 30 layers,
       d_model 3072, 24 heads, 2 KV heads, d_ff 12288, vocab 49152,
       window 4096), float32, weights from torch.Generator seed 0 drawn
       on the card; 4 prompts of 128 tokens, 16 greedy new tokens.  First
       every linear of layer 0 (q, k, v, o: 3072 x 3072 and 3072 x 256;
       up, down: 3072 x 12288 and 12288 x 3072) at the decode shape
       (4, 1, k) and the prefill shape (4, 128, k) through `apply_linear`
       on `kernel` and `fused`, unprepared and prepared on the card, each
       bitwise equal to device="cpu".  Then four engines, one at a time:
       native, `kernel` unprepared, `kernel` with prepare=True, `fused`
       with prepare=True (the launch counters zeroed just before and read
       just after each engine's generate: 720, 540 and 180 launches a
       forward call by kernel, `kernel_launch_count` x 180 linears); the
       emulated engines' tokens and logits (the prefill's and every decode
       step's) bitwise equal.  Then at full width with 2 layers: `kernel`
       prepared into a `prepared_dir` (a temporary directory, removed
       after) and constructed again, which must restore without a cast,
       both bitwise equal to unprepared; and the emulated engine's logits
       (prefill and every decode step) within SERVE_WIDE_TOL (1e-4) x
       max|logits| of the same model with float64 linears, its tokens
       equal wherever that model's top-2 margin exceeds twice that (30
       random-init layers amplify a product's rounding 1e4-fold, so the
       bound is held where it still bites).  Prints each engine's
       preparation s, prefill ms and decode ms a token (both from one
       generate), tokens/s, launches and peak memory since its
       construction;
   (c) the serve CLI once, `repro_torch.launch.serve.main` with
       --arch starcoder2-3b --backend ozaki2_f32 --execution kernel
       --prepare, on the card: exit 0 and its tokens/s.

8. The SSD, RG-LRU and MoE archs at full width (`BLOCK_ARCHS`):
   mamba2-130m (24 layers), recurrentgemma-2b (26), granite-moe-3b-a800m
   (32) whole and deepseek-moe-16b cut to 4 of its 28 layers (its float32
   params would not fit beside the prepared planes on one 80 GB card),
   float32, weights from torch.Generator seed 0 drawn on the card, B = 4,
   128-token prompts, 16 greedy new tokens, one arch at a time.  Layer
   0's linears of each kind (and recurrentgemma's first attention layer,
   layer 2) at (4, 1, k) and (4, 128, k) on `kernel` and `fused`,
   unprepared and prepared, card == cpu bitwise, with each linear's
   int8_mod_gemm launches by TMA (mamba2's in_proj, n = 3352, takes the
   global-load path); a native and a prepared `kernel` engine (launches
   = `kernel_launch_count` x 48 / 200 / 128 / 28 linears a forward call,
   from the counters; peak memory since each construction); at 2 layers
   (3 for recurrentgemma) the emulated engine within SERVE_WIDE_TOL x
   max|logits| (recurrentgemma 2e-3, SERVE_WIDE_TOL_OF) of the same model
   with float64 linears (`float64_linears`: the other leaves, the experts
   included, as they are), under the routing rule, beside native float32
   linears' distance (printed, not held).

9. Training (`repro_torch.train`), float32, the train CLI's AdamW (lr
   3e-3, grad clip 5.0), remat on:
   (a) every arch reduced under `GemmPolicy(backend="ozaki2_f32",
       execution="kernel")`: layer 0's linears of each kind at the train
       shape (2, 32, k), forward, dX and dW card == cpu bitwise; one
       `make_train_step` step on the card and on the CPU from the same
       weights (drawn on the CPU, moved) and `SyntheticLM` batch: the loss
       within TRAIN_LOSS_TOL (1e-4; recurrentgemma-2b 2e-3) relative and
       every grad leaf within TRAIN_GRAD_TOL (1e-3; recurrentgemma-2b
       1e-2) x its max|g| (MoE archs: every token routed alike on both,
       any flip fails), 16 launches a linear (forward, recompute, dX, dW);
       reduced starcoder2-3b (1 layer) under `ozaki2_c64` on `kernel`
       (karatsuba_fused): layer 0's linears at (2, 32, k) card == cpu
       bitwise, its loss within 1e-3 of native; and its grads (2 layers)
       under deterministic algorithms on `kernel`, `fused`, `fp8` and
       `per_modulus_kernel`, bitwise equal;
   (b) mamba2-130m as published (24 layers, d_model 768, vocab 50280),
       B = 8 x S = 256, weights from torch.Generator seed 0 on the card:
       layer 0's linears at the train shape card == cpu bitwise; step 0 on
       native and `kernel`, loss and grad_norm within 1e-3 relative; 6
       steps of `train_loop` (cosine warm-up 2 of 6) on each, printing the
       losses, step ms (median of steps 2-6, from the batch hook after a
       synchronize to the step's log line, after the loss was read),
       tokens/s, peak memory since the state's construction and launches
       a step (768 = 16 x 48 linears on `kernel`, from the counters); the
       resume under deterministic algorithms: 3 steps, a blocking save, a
       restore bitwise equal to the live state, and step 3 from both with
       equal loss and state bits;
   (c) starcoder2-3b at full width (d_model 3072, d_ff 12288, vocab 49152)
       with 2 of its 30 layers, B = 4 x S = 256: layer 0's six linears at
       (4, 256, k), forward, dX and dW card == cpu bitwise on 8 of every
       64 rows and columns of each output (`train_linears(sampled=True)`);
       2 steps of `train_loop` on native and `kernel` with (b)'s prints,
       step-0 losses within 1e-3;
   (d) the train CLI in subprocesses (mamba2-130m reduced, `kernel`, 10
       steps into a checkpoint directory, which saves step 10, then 12):
       both exit 0, the second resumes at step 10 and runs steps 10 and
       11, every loss finite.

10. The sharded execution (`GemmPolicy(execution="sharded")`), its ranks
    subprocesses of this script on the one card (`--rank-task`, the
    launcher's environment variables; `launch.mesh.init_world` picks the
    transport: NCCL for a world of 1, gloo for 2 and 4 ranks sharing the
    card), each rank's outputs held with `same_bits` against this
    process's single-process `kernel` outputs, saved to a temporary
    directory; a rank that fails or outlives RANK_TIMEOUT fails the run:
    (a) s/d/c/zgemm at 2048^3 (N = 8, 16, 7, 14) on (1,1,1) (1 rank,
        NCCL), (1,1,2), (2,1,1), (1,2,1), (1,1,4) and (2,2,1) (mesh dims
        data, model, residue), `fused` sgemm on (2,1,1) and zgemm on
        (1,2,1) (the megakernel on each rank's block), sgemm and zgemm at
        4096^3 on (1,1,2) and zgemm accu on (2,1,2): a warm-up call, then
        each timed (host clock around a synchronize) beside this process's
        `kernel` time, with its bytes all-reduced and its collectives'
        share of the time (`sharded_gemm.collective`, timed); sgemm 2048^3
        on (1,1,2) and the accu zgemm once more under the analysis's
        `trace` on every rank: no `CollectiveSafetyPass` finding, an f64
        SUM among the collectives (and an int32 MAX in accu mode);
    (b) starcoder2-3b at full width, cut to SHARD_SERVE_LAYERS = 2 of its
        30 layers (float32, weights from seed 0), B = 4, 128-token prompts,
        16 new tokens, served by the world of 2 on (1,1,2): tokens and
        logits bitwise this process's `kernel` engine's; prefill ms and
        decode ms a token on both;
    (c) the serve and train CLIs under `python -m torch.distributed.run
        --standalone --nproc-per-node 2 ... --execution sharded --residue
        2` (starcoder2-3b reduced; mamba2-130m reduced, 3 steps, under
        deterministic algorithms): each rank's tokens and every step's
        loss equal to the same CLI's on `--execution kernel` here, rank 0
        alone printing (both launchers at once, the `kernel` runs beside
        them).
11. The static analysis (`repro_torch.analysis`):
    (a) `python -m repro_torch.analysis --matrix smoke -v` on the card in a
        subprocess (it and (b)'s two run beside (c), each in its own
        process): every execution x dtype x mode at (32, 96, 24), the
        adaptive rows, a tiny model's train step and the lints, each row
        clean (overflow, collective safety, launch count, accuracy);
    (b) the same at (16, 2^17 + 5, 16), fast mode, over `kernel`,
        `fused`, `fp8` and `reference` and `per_modulus_kernel` on the
        real dtypes (accu's bound product and the per-modulus complex
        product refuse k > 2^17 in both packages): the int8 products in 2
        K-chunks, the e4m3 ones in 3, every row clean;
    (c) `kernel`, `per_modulus_kernel`, `fused` and `fp8`, the four
        dtypes at both shapes: a warm call, then one traced call under
        `torch.profiler`; the card's launches of each kernel (the
        profiler's events, each mapped to its wrapper by its function's
        identifier, `KERNEL_WRAPPER`) equal to the trace's launch records
        of that wrapper, and their total to `expected_launch_count`;
    (d) `OverflowPass(k_limit=K_CHUNK_LIMIT // 2)` over (b)'s `kernel`
        sgemm trace reports a finding.
12. The parameter-sharded training mesh (`train.step` on a DeviceMesh),
    its ranks subprocesses of this script sharing the card over gloo,
    under deterministic algorithms; the one-process steps they are held
    to run here first:
    (a) mamba2-130m as published (B 8 x S 256, float32, `kernel`) 2 steps
        on (2, 1), (1, 2) and (2, 2), and starcoder2-3b at full width, 2
        of 30 layers (B 4 x S 256), 1 step on (2, 2): every rank's
        gathered params, optimizer state and losses bitwise (the SHA-256
        of each leaf's bytes) the one-process step with grad_accum = D;
        step ms beside the one-process step's, the bytes gathered and
        all-reduced a step, the collectives' share; the launches of
        `kernel` (16 a linear a step on each rank);
    (b) the same on (1, 1, 2) with every linear `sharded`, against
        `kernel` on one process;
    (c) the train CLI with `--mesh 2x1` under `python -m
        torch.distributed.run --nproc-per-node 2` (mamba2-130m as
        published, 3 steps) prints on each rank the losses of one
        process with `--grad-accum 2`; from a checkpoint one process
        wrote at step 10, `--mesh 1x2` resumes to step 12: its restored
        state gathered is bitwise the checkpoint, its losses those of one
        process resumed from a copy with `--grad-accum 1`;
    (d) `error_feedback_psum` on 2 and 4 ranks bitwise its one-process
        formula; `pipeline_loss` on pp = 2 (starcoder2-3b at full width,
        2 layers, native float32): its loss within 1e-5 relative of the
        sequential model's on the card at the pipeline's microbatch
        shapes, each rank's grads within max(1e-5, 1e-3 max|g|); the
        whole-batch model's readings printed beside (`rank_pipeline`
        says why they are not held).
13. The OS I-S baseline and the dry run:
    (a) `core.ozaki1` (`ozaki1_gemm` / `ozaki1_cgemm`) at (250, 383, 517)
        and (12, 64, 64) (ragged, and m below `torch._int_mm`'s 17), S =
        5 and 9, float64 and complex128: the card's output bitwise the
        CPU's, one `torch._int_mm` a cross product
        (`ozaki1.int8_product.int_mm_calls`); then complex128 4096^3 at S
        = 9 within 1e-11 of `torch.matmul` (the reference test's bound),
        timed beside phase 3b's kernel and cuBLAS zgemm, its 3 x 45 = 135
        int8 products counted;
    (b) the dry run (`launch.dryrun`, meta tensors in a fake world, no
        card) in subprocesses started after phase 12's timed cases,
        beside 12c: the CLI for
        mamba2-130m's and qwen2.5-32b's train_4k on 16 x 16, their
        records printed; `--dry-run-task mesh|one` (this script) runs
        `dry_run` on phase 12a's mamba2-130m `kernel` step on (2, 2, 1), whose
        predicted collectives of rank 0 (count and bytes by kind) must
        equal phase 12a rank 0's `CollectiveLog` of a step, and on phase
        9b's one-process step, whose predicted launches must equal the
        card's count of that step (run here after a warm-up step) and
        whose predicted peak (arguments + temp) must lie within 0.75-1.5x
        of the card's `max_memory_allocated` during it (less what was
        allocated before its state).

The last lines are the kernels' JSON record (with each kernel's launches
in phase 7b, `serve_launches`, in phase 8, `blocks_serve_launches`, in
phase 9, `train_launches`: 9a's card steps, 9b's and 9c's steps, and in
phase 10 on rank 0, `sharded_launches`),
the card's name and power limit from nvidia-smi, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# phase 9's deterministic checks run cuBLAS under torch.use_deterministic_algorithms,
# which needs this before CUDA starts (32 MiB, the Hopper default's size)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

SEED = 0
PHI = 0.5
# NVIDIA H100 SXM data-sheet peaks (dense), at the full 700 W power limit
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP8_OPS_S = 1979e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12

# the Pallas kernel each CUDA kernel replaces
KERNELS = {
    "residue_cast": "src/repro/kernels/residue_cast.py:37",
    "int8_mod_gemm": "src/repro/kernels/int8_mod_gemm.py:51",
    "karatsuba_fused": "src/repro/kernels/karatsuba_fused.py:60",
    "crt_garner": "src/repro/kernels/crt_garner.py:97",
    "fused_mod_gemm": "src/repro/kernels/int8_mod_gemm.py:162",
    "fused_karatsuba": "src/repro/kernels/karatsuba_fused.py:194",
    "fp8_mod_gemm": "src/repro/kernels/fp8_mod_gemm.py:85",
    "fp8_karatsuba": "src/repro/kernels/fp8_mod_gemm.py:171",
    "launch_copy": "src/repro/tune/calibrate.py:138",
    "flash_attention": "src/repro/kernels/flash_attention.py:24",
}
# the main path whose launch counts each kernel reports
PATH_OF = {name: name.split("_")[0] if name.startswith(("fused", "fp8")) else "kernel" for name in KERNELS}
PATH_OF["launch_copy"] = "tune"
PATH_OF["flash_attention"] = "attention"

COPY_SHAPE = (8, 128)      # the calibration's launch-timing tile
COPY_SIZES = (1, 1023, 4097)  # copies off the kernel's 4-value groups
FUSED_COMPLEX_N = (7, 14, 21)  # the complex megakernel's NMAX 8, 16, 24 instantiations
# the real megakernel's NMAX 8, 16, 24 instantiations: 21 is the most moduli
# make_crt_context gives (P stays within 159 bits)
FUSED_REAL_N = (8, 16, 21)
INT8_K_LIMIT = 1 << 17     # the int8 Karatsuba kernel's k bound (int32 sums of 127^2 k)
LAUNCH_BOUND_SIZES = (512, 1024)  # sgemm sizes where one launch against four should tell
LAUNCH_BOUND_REPS = 20
RAGGED = (257, 1000, 129)  # (m, k, n) off every tile multiple
ALIGNED_RAGGED = (257, 1024, 144)  # ragged edges, but k and n multiples of 16: strides TMA can map
DEEP_RAGGED = (129, 4000, 129)  # k off multiples of 16 and past two turns of every ring (2 ST BK < 4000)
MAIN = 4096                # the main path's m = n = k
BIG = 8192                 # the largest zgemm of the main path
SMALL = 512                # the card-vs-cpu end-to-end parity size
REF_ROWS = {False: 8, True: 4}  # rows of phase 3(e)'s extended-precision check (real, complex)
RAGGED_CHUNK = 256         # chunk_limit forcing in-kernel reductions at RAGGED
SERVE_N = 8192             # the prepared weight's k = n
SERVE_M = (128, 1024, 8192)  # the rows of the serving requests
SERVE_M_FP8 = (1024,)      # the rows of the fp8 serving request
ATTN_FULL = (1, 32768, 40, 8, 128)  # (B, S, H, KV, D): one 32k prefill of Qwen2.5-32B
ATTN_F32_S = 4096          # the f32 check's sequence, at the same heads
ATTN_SWEEP = ((2, 256, 4, 2, 64), (1, 512, 8, 1, 32), (2, 128, 4, 4, 64))  # (B, S, H, KV, D)
ATTN_HEAD_DIM_S = 320      # the per-head-dim checks' sequence (blocks of 64)
# batches of two with a ragged tail, ((B, S, H, KV, D), Sk): S and Sk off every
# tile multiple, where a TMA box that crossed a batch would read the next batch
ATTN_BATCH_EDGES = (((2, 200, 8, 2, 128), None), ((2, 128, 8, 2, 128), 200))
ATTN_F32_TOL = 2e-5        # f32: max|kernel - plain|, tests/test_kernels.py's tolerance
ATTN_BF16_ROW_TOL = 2e-2   # bf16: the largest `attention_row_err` of kernel against plain
ATTN_CONTROL = torch.float8_e4m3fn  # the plain version with P in this type must read over it


# the integer type whose view holds a floating type's bits
BITS_OF = {torch.float16: torch.int16, torch.bfloat16: torch.int16, torch.float32: torch.int32,
           torch.float64: torch.int64}


def bits(t):
    """`t` as the integer view of its bits (complex: of its real and
    imaginary parts); integer tensors as they are."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(BITS_OF[t.dtype]) if t.dtype in BITS_OF else t


def same_bits(got, want) -> bool:
    """Equal dtype, shape and bits.  Floating outputs are compared through
    their integer views: `torch.equal` counts -0.0 equal to +0.0."""
    return got.dtype == want.dtype and torch.equal(bits(got), bits(want))


def first_difference(got, want) -> str:
    """How two outputs differ: the count of differing elements, the first
    index, both values and both bit patterns there."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return f"{got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}"
    gb, wb = bits(got), bits(want)
    bad = (gb != wb).nonzero()
    first = tuple(int(i) for i in bad[0])
    width = 2 * gb.element_size()
    pattern = lambda t: format(int(t[first]) & ((1 << 4 * width) - 1), f"0{width}x")  # noqa: E731
    value = lambda t: t[first[:got.dim()]].item()  # noqa: E731
    return (f"{bad.shape[0]} elements; first at {first}: {value(got)!r} (0x{pattern(gb)}) "
            f"against {value(want)!r} (0x{pattern(wb)})")


def phi_matrix(rng, shape, phi, dtype):
    """The paper's SIV-A test-matrix generator: (rand-0.5)*exp(randn*phi)."""
    u = rng.random(shape)
    g = rng.standard_normal(shape)
    m = (u - 0.5) * np.exp(g * phi)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        u2 = rng.random(shape)
        g2 = rng.standard_normal(shape)
        m = m + 1j * (u2 - 0.5) * np.exp(g2 * phi)
    return m.astype(dtype)


def cuda_ms(fn, reps):
    """Mean milliseconds of `fn` over `reps` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Mean device milliseconds of `fn` over `reps` back-to-back runs, by CUDA
    events, with the stream held busy (`torch.cuda._sleep`) while the host
    enqueues them, so the host's launch path does not pace the device: for
    a kernel too small to outlast its own launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time, longer than the enqueueing
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tile_label(tile) -> str:
    return "x".join(str(x) for x in tile)


# how a source's compiled variants are labelled, from their mangled names:
# by Tile<BM,BN,BK,WARPS_N> (the GEMM kernels), or as the source lists here
TILE_LABEL = (re.compile(r"TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"), lambda g: "tile " + tile_label(g[:3]))
# the path each attention input type takes, at every head dim
ATTN_PATHS = {"bf16": "TMA ring, warp-specialised wgmma", "f32": "SIMT, 64-row tiles"}
PTXAS_LABELS = {"flash_attention": (re.compile(r"fa_(f32|bf16)_kernelILi(\d+)E"),
                                    lambda g: f"{g[0]} D={g[1]} ({ATTN_PATHS[g[0]]})"),
                # fp8_karatsuba_kernel<BK, stages, TMA>: the tile 64 x 64 x BK
                "fp8_karatsuba": (re.compile(r"fp8_karatsuba_kernelILi(\d+)ELi\d+ELb\d+E"),
                                  lambda g: "tile " + tile_label((64, 64, g[0]))),
                # fp8_mod_gemm_kernel<BK, stages, TMA>: the tile 128 x 64 x BK
                "fp8_mod_gemm": (re.compile(r"fp8_mod_gemm_kernelILi(\d+)ELi\d+ELb\d+E"),
                                 lambda g: "tile " + tile_label((128, 64, g[0]))),
                # karatsuba_kernel<BN, BK, stages, TMA>: the tile 64 x BN x BK
                "karatsuba_fused": (re.compile(r"karatsuba_kernelILi(\d+)ELi(\d+)ELi\d+ELb\d+E"),
                                    lambda g: "tile " + tile_label((64, g[0], g[1]))),
                # int8_mod_gemm_kernel<BM, BN, BK, stages, TMA>
                "int8_mod_gemm": (re.compile(r"int8_mod_gemm_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi\d+ELb\d+E"),
                                  lambda g: "tile " + tile_label(g)),
                # crt_garner_kernel<NMAX, VEC, DD>
                "crt_garner": (re.compile(r"crt_garner_kernelILi(\d+)ELb(\d)ELb(\d)E"),
                               lambda g: f"nmax={g[0]} {'vector' if g[1] == '1' else 'scalar'} "
                                         f"{'double-single' if g[2] == '1' else 'f32'}")}
# the kernels that fail phase 1 if they spill at their default tile
NO_SPILL_AT_DEFAULT = {"fp8_karatsuba": ("fp8", "complex"), "fp8_mod_gemm": ("fp8", "real"),
                       "karatsuba_fused": ("kernel", "complex"), "fused_mod_gemm": ("fused", "real"),
                       "int8_mod_gemm": ("kernel", "real")}
WGMMA_SERIALIZED = "wgmma.mma_async instructions are serialized"  # ptxas's warning (C7512)


def ptxas_tiles(logs):
    """{source: {label: (most registers, most spill-store bytes, variants)}}
    over every compiled variant of each label (a GEMM tile's VEC, N bound
    and prepared variants; an attention (type, head dim)), from the
    `-Xptxas -v` reports."""
    out = {}
    for name, log in logs.items():
        label_re, label_of = PTXAS_LABELS.get(name, TILE_LABEL)
        entry, spill = None, 0
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                entry, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                t = label_re.search(entry)
                if t:
                    label = label_of(t.groups())
                    regs, spills, count = out.setdefault(name, {}).get(label, (0, 0, 0))
                    out[name][label] = (max(regs, int(m.group(1))), max(spills, spill), count + 1)
                entry = None
    return out


def attention_row_err(got, want):
    """The bf16 check's reading: the largest (|got - want| - 2^-7 |want|) /
    rms(want's row) over the elements.  2^-7 |want| is what rounding both
    outputs to bf16 can add (half an ulp each); the rest is their difference
    before that rounding (P rounded to bf16, the order of the sums), which
    scales with the size of the row: the RMS over the head dim of want's
    (b, s, h) row.  An absolute limit would bind only on the first rows,
    whose outputs average few keys and are 20-80x larger than the 32k
    prefill's last rows."""
    g, w = got.float(), want.float()
    row = w.square().mean(-1, keepdim=True).sqrt_()
    return float(((g - w).abs_() - w.abs() * 2.0**-7).div_(row).max())


def attention_work(q, k, causal):
    """(bytes, flop) the attention function needs: q, k, v read once and o
    written once; 4 D flop for each (query, key) pair the mask keeps (QK^T
    and PV), in each query head."""
    b, s, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    pairs = sum(min(i + 1, sk) for i in range(s)) if causal else s * sk
    return q.element_size() * b * d * (2 * s * h + 2 * sk * kv), 4 * d * h * b * pairs


def cast_flops(n_mod, n_limbs):
    """f32 operations that one element's residue cast needs on the
    division-free route (`residue_fma.cuh`), an FMA counted as 2 as the 67
    TFLOP/s peak counts it: the scale product (1); the peel of each limb
    above the lowest, a multiply and an fma (3); per plane, each limb's
    residue (fma, add, fma: 5), the radix sum (the lowest limb's radix is
    2^0 = 1, so the sum starts from its residue and takes one fma a limb
    above it: 2 each) and the final reduce (5).  Packing the residues into
    bytes is not arithmetic of the function and is not counted."""
    return 1 + 3 * (n_limbs - 1) + n_mod * (5 * n_limbs + 2 * (n_limbs - 1) + 5)


def garner_flops(n_mod, out_dd):
    """f32 operations that one output element of the Garner kernel's route
    (`csrc/crt_garner.cu`) needs, an FMA counted as 2 as the 67 TFLOP/s
    peak counts it: a residue byte to f32 (one subtraction, N); for each
    digit t >= 1, the sum of t + 1 terms by fmas from 0 (2 (t + 1)) and
    one reduction (multiply, add, subtract, fma: 5), (N - 1)(N + 7) in
    all; the double-single sum, a digit a product (1), three fmas (6) and
    `dd_add` (11); the inverse scaling, 4 multiplies for the pair (3 with
    one add for f32).  The scale products of a row or a column are not
    counted per element."""
    return n_mod + (n_mod - 1) * (n_mod + 7) + 18 * n_mod + (4 if out_dd else 3)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


class KernelChecks:
    """Phase 2: each kernel against its plain version, bitwise, on the card."""

    def __init__(self, rng, dev):
        from repro_torch.kernels import crt_garner, fp8_mod_gemm, int8_mod_gemm, karatsuba_fused, residue_cast

        self.rng, self.dev = rng, dev
        self.mods = (residue_cast, int8_mod_gemm, karatsuba_fused, crt_garner)
        self.f8 = fp8_mod_gemm
        from repro_torch.kernels.common import COMPILED_TILES, TILE_SOURCES

        # the compiled tiles of each GEMM kernel, by the kernel's name
        self.tiles_of = {name: COMPILED_TILES[slot] for slot, name in TILE_SOURCES.items()}
        self.record = {name: {"max_abs_err": 0.0} for name in KERNELS}
        for name in self.tiles_of:
            self.record[name]["tiles_ms"] = {}

    def time_tile(self, name, tile, kernel, want, reps):
        """A non-default tile of `name` at the main path's shape: its output
        equal to the default tile's (`want`) bitwise, and its time."""
        got = kernel()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        if not all(same_bits(g, w) for g, w in pairs):
            raise AssertionError(f"{name} tile {tile}: differs from the default tile's output")
        ms = cuda_ms(kernel, reps)
        self.record[name]["tiles_ms"][tile_label(tile)] = ms
        print(f"  {name} tile {tile_label(tile)}: ms={ms:.4f} == default tile, bitwise", flush=True)

    def default_tile_ms(self, name):
        """File the timed default run under its tile as well."""
        self.record[name]["tiles_ms"][tile_label(self.tiles_of[name][0])] = self.record[name]["ms"]

    def other_tiles(self, name):
        return self.tiles_of[name][1:]

    def tiles(self):
        """Every compiled tile of the six GEMM kernels against its plain
        version at RAGGED, bitwise: the product kernels with and without
        carry, the megakernels with raw and prepared B at chunk_limit 256
        and 2^17."""
        from repro_torch.core.moduli import make_crt_context

        _, ig, kf, _ = self.mods
        f8 = self.f8
        m, k, n = RAGGED
        for n_mod, complex_ in ((8, False), (14, True)):
            mods = make_crt_context(n_mod).moduli
            if complex_:
                ops = [self.residues(mods, shape) for shape in ((m, k), (m, k), (k, n), (k, n))]
                carry = (self.residues(mods, (m, n)), self.residues(mods, (m, n)))
                pairs = (("karatsuba_fused", kf.karatsuba_mod_gemm_batched, kf.karatsuba_mod_gemm_plain),
                         ("fp8_karatsuba", f8.fp8_karatsuba_mod_gemm_batched, f8.fp8_karatsuba_mod_gemm_plain))
            else:
                ops = [self.residues(mods, (m, k)), self.residues(mods, (k, n))]
                carry = self.residues(mods, (m, n))
                pairs = (("int8_mod_gemm", ig.int8_mod_gemm_batched, ig.int8_mod_gemm_plain),
                         ("fp8_mod_gemm", f8.fp8_mod_gemm_batched, f8.fp8_mod_gemm_plain))
            for name, wrapper, plain in pairs:
                for tile in self.tiles_of[name]:
                    for c in (None, carry):
                        self.compare(name, lambda: wrapper(*ops, moduli=mods, carry=c, tile=tile),
                                     lambda: plain(*ops, moduli=mods, carry=c))
                    print(f"  {name} tile {tile_label(tile)} {m}x{k}x{n} N={n_mod}: "
                          f"== plain with and without carry, bitwise", flush=True)
        for dtype, n_mods in ((np.float32, FUSED_REAL_N), (np.complex64, FUSED_COMPLEX_N)):
            for n_mod in n_mods:
                for chunk_limit in (RAGGED_CHUNK, 1 << 17):
                    self.megakernels(RAGGED, dtype, n_mod, chunk_limit=chunk_limit, timed=False,
                                     all_tiles=True)

    def clusters(self):
        """The two megakernels' launches: their thread-block cluster and the
        most such clusters the card holds at once, per compiled tile and N."""
        from repro_torch.kernels.int8_mod_gemm import fused_mod_cluster_info
        from repro_torch.kernels.karatsuba_fused import fused_cluster_info

        for name, info_of, n_mods in (("fused_mod_gemm", fused_mod_cluster_info, FUSED_REAL_N),
                                      ("fused_karatsuba", fused_cluster_info, FUSED_COMPLEX_N)):
            rec = self.record[name]["clusters"] = {}
            for tile in self.tiles_of[name]:
                for n_mod in n_mods:
                    info = info_of(n_mod, tile)
                    rec[f"{tile_label(tile)} N={n_mod}"] = info
                    print(f"  {name} tile {tile_label(tile)} N={n_mod}: cluster "
                          f"{info['cluster'][0]}x{info['cluster'][1]} (m x n), at most "
                          f"{info['max_active_clusters']} clusters at once, {info['smem_bytes']} B of "
                          f"shared memory a block, {info['stages']} staging buffer(s)", flush=True)
                    if info["max_active_clusters"] < 1:
                        raise AssertionError(f"{name} tile {tile} N={n_mod}: no cluster fits")
        from repro_torch.kernels.fp8_mod_gemm import fp8_cluster_info, fp8_mod_cluster_info

        for name, info_of, n_mods in (("fp8_karatsuba", fp8_cluster_info, FUSED_COMPLEX_N),
                                      ("fp8_mod_gemm", fp8_mod_cluster_info, FUSED_REAL_N)):
            rec = self.record[name]["clusters"] = {}
            for tile in self.tiles_of[name]:
                for n_mod in n_mods:
                    info = info_of(n_mod, tile)
                    rec[f"{tile_label(tile)} N={n_mod}"] = info
                    raw = f", {info['raw_stages']} raw stage(s)" if "raw_stages" in info else ""
                    print(f"  {name} tile {tile_label(tile)} N={n_mod}: cluster "
                          f"{info['cluster'][0]}x{info['cluster'][1]} (m x n), at most "
                          f"{info['max_active_clusters']} clusters at once, {info['smem_bytes']} B of "
                          f"shared memory a block, {info['stages']} stage(s){raw}", flush=True)
                    if info["max_active_clusters"] < 1:
                        raise AssertionError(f"{name} tile {tile} N={n_mod}: no cluster fits")

    def load_paths(self, name):
        """A kernel with two load paths (`fp8_karatsuba`, `karatsuba_fused`,
        `fp8_mod_gemm`, `int8_mod_gemm`) on both, every tile, bitwise
        against its plain version (the e4m3 ones also against the int8
        kernel), with and without carry: RAGGED (k and n off multiples of
        16: the kernel's threads load from global memory) at N = 7, 14 and
        21 (real: 8, 16, 21), DEEP_RAGGED (global loads over more than two
        turns of every ring, where warps that take slices in turn would
        outrun the stages) at N = 14 (real: 8), and ALIGNED_RAGGED (TMA,
        ragged edges) at N = 14 (real: 8).  The real ones also at
        ALIGNED_RAGGED on views 1 byte into their storage (not 16-byte
        aligned: global loads, byte by byte).  The wrapper's counts show
        which path each launch took."""
        from repro_torch.core.moduli import make_crt_context

        _, ig, kf, _ = self.mods
        f8 = self.f8
        wrapper, plain, int8_of = {
            "fp8_karatsuba": (f8.fp8_karatsuba_mod_gemm_batched, f8.fp8_karatsuba_mod_gemm_plain,
                              kf.karatsuba_mod_gemm_batched),
            "karatsuba_fused": (kf.karatsuba_mod_gemm_batched, kf.karatsuba_mod_gemm_plain, None),
            "fp8_mod_gemm": (f8.fp8_mod_gemm_batched, f8.fp8_mod_gemm_plain, ig.int8_mod_gemm_batched),
            "int8_mod_gemm": (ig.int8_mod_gemm_batched, ig.int8_mod_gemm_plain, None),
        }[name]
        real = name in ("fp8_mod_gemm", "int8_mod_gemm")
        cases = [(RAGGED, FUSED_REAL_N if real else FUSED_COMPLEX_N, False, 0),
                 (DEEP_RAGGED, (8,) if real else (14,), False, 0),
                 (ALIGNED_RAGGED, (8,) if real else (14,), True, 0)]
        if real:
            cases.append((ALIGNED_RAGGED, (8,), False, 1))
        rec = self.record[name]["paths"] = {}
        for shape, n_mods, tma, offset in cases:
            m, k, n = shape
            for n_mod in n_mods:
                mods = make_crt_context(n_mod).moduli
                shapes = ((m, k), (k, n)) if real else ((m, k), (m, k), (k, n), (k, n))
                ops = [self.residues(mods, s, offset=offset) for s in shapes]
                carry = self.residues(mods, (m, n))
                if not real:
                    carry = (carry, self.residues(mods, (m, n)))
                int8 = None
                if int8_of is not None:
                    int8 = {None: int8_of(*ops, moduli=mods), "carry": int8_of(*ops, moduli=mods, carry=carry)}
                for tile in self.tiles_of[name]:
                    before = (wrapper.launches, wrapper.tma_launches)
                    for c in (None, carry):
                        got = self.compare(
                            name, lambda: wrapper(*ops, moduli=mods, carry=c, tile=tile),
                            lambda: plain(*ops, moduli=mods, carry=c))
                        if int8 is not None:
                            self.same_as_int8(name, got, int8[None if c is None else "carry"],
                                              f"{m}x{k}x{n} N={n_mod} tile {tile_label(tile)}")
                    launched = wrapper.launches - before[0]
                    by_tma = wrapper.tma_launches - before[1]
                    label = f"{m}x{k}x{n} N={n_mod} tile {tile_label(tile)}"
                    if offset:
                        label += f", views {offset} byte(s) into their storage"
                    rec[label] = {"launches": launched, "tma_launches": by_tma}
                    print(f"  {name} {label}: == plain{' == int8' if int8 else ''} with and without carry, "
                          f"bitwise; {launched} launches, {by_tma} of them by TMA", flush=True)
                    if by_tma != (launched if tma else 0):
                        raise AssertionError(f"{name} {label}: {by_tma} of {launched} launches took "
                                             f"the TMA path, expected {'all' if tma else 'none'}")

    def karatsuba_worst_case(self):
        """The int8 Karatsuba kernel at its k bound, k = 2^17, m = n = 128, N
        = 8, every tile, with and without carry, against its plain version:
        planes of -127 (AR = AI = BR = BI: |D|, |E| reach 127^2 k, the most
        an int32 sum may hold), and AR = 127, AI = 0 against BR = -127, BI
        = 0 (the F operands at +-127, their largest)."""
        from repro_torch.core.moduli import make_crt_context

        _, _, kf, _ = self.mods
        mods = make_crt_context(8).moduli
        k = INT8_K_LIMIT
        neg = lambda shape: torch.full((8, *shape), -127, dtype=torch.int8, device=self.dev)  # noqa: E731
        zero = lambda shape: torch.zeros((8, *shape), dtype=torch.int8, device=self.dev)  # noqa: E731
        cases = {"-127": (neg((128, k)), neg((128, k)), neg((k, 128)), neg((k, 128))),
                 "largest sums": (-neg((128, k)), zero((128, k)), neg((k, 128)), zero((k, 128)))}
        carry = (self.residues(mods, (128, 128)), self.residues(mods, (128, 128)))
        for label, ops in cases.items():
            for tile in self.tiles_of["karatsuba_fused"]:
                for c in (None, carry):
                    self.compare("karatsuba_fused",
                                 lambda: kf.karatsuba_mod_gemm_batched(*ops, moduli=mods, carry=c, tile=tile),
                                 lambda: kf.karatsuba_mod_gemm_plain(*ops, moduli=mods, carry=c))
                print(f"  karatsuba_fused worst case 128x{k}x128 N=8 {label} tile {tile_label(tile)}: == plain "
                      "with and without carry, bitwise", flush=True)

    def int8_worst_case(self):
        """The int8 real kernel at its k bound, k = 2^17, m = n = 128, N = 8,
        every tile, with and without carry, against its plain version:
        planes of -127 (A = B: every product 127^2, the sums at 127^2 k, the
        most an int32 may hold), and every residue at its largest magnitude,
        A_l = (p_l - 1) / 2 against B_l = -(p_l - 1) / 2."""
        from repro_torch.core.moduli import make_crt_context

        _, ig, _, _ = self.mods
        mods = make_crt_context(8).moduli
        k = INT8_K_LIMIT
        half = torch.tensor([(p - 1) // 2 for p in mods], dtype=torch.int8, device=self.dev)[:, None, None]
        cases = {"-127": (torch.full((8, 128, k), -127, dtype=torch.int8, device=self.dev),
                          torch.full((8, k, 128), -127, dtype=torch.int8, device=self.dev)),
                 "largest residues": (half.expand(8, 128, k).contiguous(), (-half).expand(8, k, 128).contiguous())}
        carry = self.residues(mods, (128, 128))
        for label, (a, b) in cases.items():
            for tile in self.tiles_of["int8_mod_gemm"]:
                for c in (None, carry):
                    self.compare("int8_mod_gemm",
                                 lambda: ig.int8_mod_gemm_batched(a, b, moduli=mods, carry=c, tile=tile),
                                 lambda: ig.int8_mod_gemm_plain(a, b, moduli=mods, carry=c))
                print(f"  int8_mod_gemm worst case 128x{k}x128 N=8 {label} tile {tile_label(tile)}: == plain "
                      "with and without carry, bitwise", flush=True)

    def int8_global_ms(self, mods, m, k, n):
        """The int8 real kernel on its global-load path at the main path's
        size, (m, k, n - 4) (n a multiple of 4 but not of 16: TMA cannot map
        B's rows), held bitwise against its plain version with no TMA
        launch, and timed beside its TMA path (`global_ms`)."""
        ig = self.mods[1]
        wrapper = ig.int8_mod_gemm_batched
        a, b = self.residues(mods, (m, k)), self.residues(mods, (k, n - 4))
        tma_before = wrapper.tma_launches
        if not same_bits(wrapper(a, b, moduli=mods), ig.int8_mod_gemm_plain(a, b, moduli=mods)):
            raise AssertionError(f"int8_mod_gemm {m}x{k}x{n - 4}: differs from its plain version")
        ms = cuda_ms(lambda: wrapper(a, b, moduli=mods), 5)
        if wrapper.tma_launches != tma_before:
            raise AssertionError(f"int8_mod_gemm {m}x{k}x{n - 4}: a launch took the TMA path")
        self.record["int8_mod_gemm"]["global_ms"] = ms
        print(f"  int8_mod_gemm {m}x{k}x{n - 4} N={len(mods)} (global loads): ms={ms:.4f} == plain, bitwise; "
              f"TMA path at {m}x{k}x{n}: {self.record['int8_mod_gemm']['ms']:.4f}", flush=True)

    def garner_cases(self):
        """The Garner kernel against its plain version, bitwise, at S = 1
        and 2 and N = 1-21, to f32 and to double-single: at n = 131 (off
        multiples of 4: the scalar instantiation), at n = 256 (the vector
        one), on residues 1 byte into their storage (not 4-byte aligned:
        scalar), and on bytes over the whole int8 range (residues need not
        be canonical)."""
        from repro_torch.core.moduli import make_crt_context

        cg = self.mods[3]
        for n_mod in range(1, 22):
            ctx = make_crt_context(n_mod)
            for s in (1, 2):
                for m, n, offset, whole in ((33, 131, 0, False), (65, 256, 0, False), (17, 64, 1, False),
                                            (9, 260, 0, True)):
                    if whole:
                        planes = torch.from_numpy(self.rng.integers(-128, 128, (s, n_mod, m, n), dtype=np.int8))
                    else:
                        planes = self.residues(ctx.moduli, (s, m, n)).transpose(0, 1)
                    e_res = torch.empty(planes.numel() + offset, dtype=torch.int8, device=self.dev)
                    e_res = e_res[offset:].view(planes.shape)
                    e_res.copy_(planes)
                    e_mu = torch.from_numpy(self.rng.integers(20, 70, m).astype(np.int32)).to(self.dev)
                    e_nu = torch.from_numpy(self.rng.integers(20, 70, n).astype(np.int32)).to(self.dev)
                    for out_dd in (False, True):
                        self.compare("crt_garner", lambda: cg.crt_garner(e_res, e_mu, e_nu, ctx, out_dd=out_dd),
                                     lambda: cg.crt_garner_plain(e_res, e_mu, e_nu, ctx, out_dd=out_dd))
            print(f"  crt_garner N={n_mod} S=1 and 2, n = 131, 256 and 260, views 1 byte in, whole-range bytes: "
                  "== plain to f32 and double-single, bitwise", flush=True)

    def launch_copy(self):
        """The launch-timing copy kernel against x.clone() on the
        calibration's tile, bitwise; timed by CUDA events, by host wall time
        through the wrapper, and x.clone() beside it."""
        from repro_torch.kernels import launch_copy as lc

        for size in COPY_SIZES:
            buf = torch.from_numpy(self.rng.standard_normal(size + 1).astype(np.float32)).to(self.dev)
            for view in (buf[:size], buf[1:]):
                self.compare("launch_copy", lambda: lc.launch_copy(view), lambda: view.clone())
            print(f"  launch_copy {size} f32, aligned and 4 bytes into its storage: == x.clone(), "
                  "bitwise", flush=True)
        x = torch.from_numpy(self.rng.standard_normal(COPY_SHAPE).astype(np.float32)).to(self.dev)
        nbytes = 2 * x.numel() * 4
        self.compare("launch_copy", lambda: lc.launch_copy(x), lambda: lc.launch_copy_plain(x),
                     timed=(f"{COPY_SHAPE[0]}x{COPY_SHAPE[1]} f32", nbytes, 0, INT8_OPS_S, 1000))
        rec = self.record["launch_copy"]
        rec["events_ms"] = rec["ms"]  # paced by the host's launch path
        rec["ms"] = device_ms(lambda: lc.launch_copy(x), 1000)
        rec["plain_ms"] = device_ms(lambda: lc.launch_copy_plain(x), 1000)
        rec["library_ms"] = device_ms(lambda: x.clone(), 1000)
        print(f"  launch_copy: device ms with the queue held full={rec['ms']:.5f} "
              f"plain (x.clone()) ms={rec['plain_ms']:.5f}", flush=True)
        walls = []
        for _ in range(200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lc.launch_copy(x)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rec["wall_ms"] = statistics.median(walls) * 1e3
        print(f"  launch_copy: wall_ms through the wrapper (median of 200, synchronized)="
              f"{rec['wall_ms']:.5f} library_ms (x.clone(), queue held full)={rec['library_ms']:.5f}",
              flush=True)

    def attention_inputs(self, b, s, h, kv, d, dtype, sk=None):
        """Standard-normal q (B,S,H,D), k and v (B,Sk,KV,D) from the run's rng,
        in f32 and rounded once to `dtype`, on the card."""
        sk = s if sk is None else sk
        return tuple(
            torch.from_numpy(self.rng.standard_normal(shape, dtype=np.float32)).to(self.dev).to(dtype)
            for shape in ((b, s, h, d), (b, sk, kv, d), (b, sk, kv, d)))

    def attention_case(self, q, k, v, *, causal=True, timed=False, **blocks):
        """The attention kernel against its plain version on the same inputs,
        in the working type: f32 within `ATTN_F32_TOL` of it, bf16 within
        `ATTN_BF16_ROW_TOL` by `attention_row_err`, where the plain version
        with P rounded to `ATTN_CONTROL` must read over that limit.  With
        `timed`, both timed (CUDA events) with the bound of this shape.
        Returns the kernel's output."""
        from repro_torch.kernels import flash_attention as fa

        got = fa.flash_attention(q, k, v, causal=causal, **blocks)
        want = fa.flash_attention_plain(q, k, v, causal=causal, **blocks)
        b, s, h, d = q.shape
        label = (f"B={b} S={s} Sk={k.shape[1]} H={h} KV={k.shape[2]} D={d} "
                 f"{str(q.dtype).removeprefix('torch.')} {'causal' if causal else 'full'}")
        if got.dtype != q.dtype or got.shape != q.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {label}: not a finite tensor of q's type and shape")
        err = float((got.float() - want.float()).abs().max())
        rec = self.record["flash_attention"]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        by_type = rec.setdefault("max_abs_err_by_type", {})
        key = str(q.dtype).removeprefix("torch.")
        by_type[key] = max(by_type.get(key, 0.0), err)
        if q.dtype == torch.float32:
            if not err <= ATTN_F32_TOL:
                raise AssertionError(f"flash_attention {label}: max|kernel - plain| = {err} > {ATTN_F32_TOL}")
            line = f"  flash_attention {label}: max_abs_err={err:.3e} (limit {ATTN_F32_TOL:g})"
        else:
            row_err = attention_row_err(got, want)
            control = attention_row_err(
                fa.flash_attention_plain(q, k, v, causal=causal, p_dtype=ATTN_CONTROL, **blocks), want)
            if not row_err <= ATTN_BF16_ROW_TOL:
                raise AssertionError(f"flash_attention {label}: row_err {row_err} > {ATTN_BF16_ROW_TOL}")
            if not control > ATTN_BF16_ROW_TOL:
                raise AssertionError(f"flash_attention {label}: the control (P in {ATTN_CONTROL}) reads "
                                     f"{control} <= {ATTN_BF16_ROW_TOL}; the limit would not see it")
            rec["row_err"] = max(rec.get("row_err", 0.0), row_err)
            rec["control_row_err"] = min(rec.get("control_row_err", float("inf")), control)
            line = (f"  flash_attention {label}: max_abs_err={err:.3e} row_err={row_err:.3e} "
                    f"(limit {ATTN_BF16_ROW_TOL:g}; control, P in e4m3: {control:.3e})")
        if timed:
            nbytes, flop = attention_work(q, k, causal)
            peak = BF16_OPS_S if q.dtype == torch.bfloat16 else F32_OPS_S
            byte_ms, op_ms = nbytes / HBM_BYTES_S * 1e3, flop / peak * 1e3
            row = {
                "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal, **blocks), 3),
                "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal, **blocks), 1),
                "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "shape": label,
            }
            line += (f" kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                     f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                     f"TFLOP/s={flop / row['ms'] / 1e9:.1f}")
            if q.dtype == torch.bfloat16:
                rec.update(row)
            else:
                rec["f32"] = row
        print(line, flush=True)
        return got

    def attention(self):
        """Phase 2's attention checks (see the module docstring).  Keeps the
        full-width bf16 inputs and the kernel's output for phase 6."""
        import torch.nn.functional as F

        from repro_torch.kernels.flash_attention import HEAD_DIMS

        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for shape in ATTN_SWEEP:
                    self.attention_case(*self.attention_inputs(*shape, dtype), causal=causal)
                self.attention_case(*self.attention_inputs(1, 200, 4, 2, 32, dtype), causal=causal)
                self.attention_case(*self.attention_inputs(1, 128, 4, 2, 64, dtype, sk=256), causal=causal)
                for shape, sk in ATTN_BATCH_EDGES:
                    self.attention_case(*self.attention_inputs(*shape, dtype, sk=sk), causal=causal)
            for d in HEAD_DIMS:
                self.attention_case(*self.attention_inputs(1, ATTN_HEAD_DIM_S, 8, 2, d, dtype), bq=64, bk=64)
        b, s, h, kv, d = ATTN_FULL
        self.attention_case(*self.attention_inputs(b, ATTN_F32_S, h, kv, d, torch.float32), timed=True)
        torch.cuda.empty_cache()
        q, k, v = self.attention_inputs(b, s, h, kv, d, torch.bfloat16)
        out = self.attention_case(q, k, v, timed=True)

        def library():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                  is_causal=True, enable_gqa=True)

        rec = self.record["flash_attention"]
        rec["library_max_abs_diff"] = float((library().transpose(1, 2).float() - out.float()).abs().max())
        rec["library_ms"] = cuda_ms(library, 3)
        print(f"  flash_attention {rec['shape']}: library_ms (scaled_dot_product_attention, default "
              f"backend)={rec['library_ms']:.4f}, max|library - kernel|="
              f"{rec['library_max_abs_diff']:.3e} (for information)", flush=True)
        self.full_attention = (q, k, v, out)

    def compare(self, name, kernel, plain, *, timed=None):
        """Run `kernel()` and `plain()`, require equal bits, and with `timed`
        = (label, bytes, ops, ops_per_s, reps) time both and keep the numbers."""
        got, want = kernel(), plain()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        err = 0.0
        for g, w in pairs:
            if not same_bits(g, w):
                raise AssertionError(f"{name}: kernel differs from its plain version: {first_difference(g, w)}")
            err = max(err, float((g.double() - w.double()).abs().max()))
        self.record[name]["max_abs_err"] = max(self.record[name]["max_abs_err"], err)
        if timed is not None:
            label, nbytes, ops, ops_per_s, reps = timed
            byte_ms, op_ms = nbytes / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
            row = {
                "ms": cuda_ms(kernel, reps),
                "plain_ms": cuda_ms(plain, max(1, reps // 5)),
                "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "shape": label,
            }
            self.record[name].update(row)
            print(f"  {name} {label}: kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
        return got

    def same_as_int8(self, name, got, want, what):
        """Require the e4m3 kernel's residues to equal the int8 kernel's."""
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        if not all(same_bits(g, w) for g, w in pairs):
            raise AssertionError(f"{name} {what}: differs from the int8 kernel on the same planes")

    def scaled_mm_yardstick(self, name, operand_pairs):
        """torch._scaled_mm (e4m3 in, unit scales, f32 out) over the 4 digit
        products (HH, LL and the two halves of X) of each (A, B) int8 plane
        pair: the products alone, without the split, the rescale or the mod
        (a yardstick, not the function)."""
        one = torch.ones((), dtype=torch.float32, device=self.dev)
        prods = []
        for a, b in operand_pairs:
            ah, al = (d.to(torch.float8_e4m3fn) for d in self.f8.digits(a.float()))
            bh, bl = (d.t().contiguous().to(torch.float8_e4m3fn).t() for d in self.f8.digits(b.float()))
            prods += [(ah, bh), (al, bl), (ah, bl), (al, bh)]
        ms = cuda_ms(lambda: [torch._scaled_mm(x, y, one, one, out_dtype=torch.float32) for x, y in prods], 3)
        self.record[name]["scaled_mm_ms"] = ms
        print(f"  {name}: torch._scaled_mm over the same {len(prods)} e4m3 digit products "
              f"(product-only yardstick) ms={ms:.4f}", flush=True)

    def residue_cast_cases(self):
        """The residue cast against its plain version, bitwise: both scale
        axes, S = 1 and 2 (and a 2-D input), n_limbs 1-4 (N = 2, 8, 14, 20),
        at a ragged odd k (the scalar path), at a k that is a multiple of 4
        (the vector path), on an input view 4 bytes into its storage and on
        scale views 4 bytes into theirs (not 16-byte aligned: the scalar
        path), and on one 16 bytes in (aligned again: the vector path).
        Then a modulus outside odd 5..255 must be refused by the wrapper
        and by the C entry, with no launch and no fallback."""
        from repro_torch.core import scaling
        from repro_torch.core.moduli import make_crt_context
        from repro_torch.core.plan import n_limbs_for_ctx
        from repro_torch.kernels.common import limb_radix_f32, split_scale_exponent

        rc = self.mods[0]

        def offset_view(x, floats):
            buf = torch.empty(x.numel() + floats, dtype=x.dtype, device=x.device)
            view = buf[floats:].view(x.shape)
            view.copy_(x)
            return view

        limbs_seen = set()
        for n_mod in (2, 8, 14, 20):
            ctx = make_crt_context(n_mod)
            nl = n_limbs_for_ctx(ctx)
            limbs_seen.add(nl)
            for stack in (1, 2):
                dtype = np.complex64 if stack == 2 else np.float32
                for m, k in ((257, 1001), (64, 1024)):
                    x = torch.from_numpy(phi_matrix(self.rng, (m, k), PHI, dtype)).to(self.dev)
                    y = torch.from_numpy(phi_matrix(self.rng, (k, 16), PHI, dtype)).to(self.dev)
                    w = torch.from_numpy(phi_matrix(self.rng, (16, m), PHI, dtype)).to(self.dev)
                    if stack == 2:
                        e_rows = scaling.scale_fast_complex(x.real, x.imag, y.real, y.imag, ctx)[0]
                        e_cols = scaling.scale_fast_complex(w.real, w.imag, x.real, x.imag, ctx)[1]
                        xs = torch.stack([x.real, x.imag]).float()
                    else:
                        e_rows = scaling.scale_fast_real(x, y, ctx)[0]
                        e_cols = scaling.scale_fast_real(w, x, ctx)[1]
                        xs = x.float()[None]
                    for axis, e in ((0, e_rows), (1, e_cols)):
                        s1, s2 = split_scale_exponent(e)
                        kw = dict(moduli=ctx.moduli, n_limbs=nl, scale_axis=axis)
                        variants = {"": (xs, s1, s2), "input 4 B in": (offset_view(xs, 1), s1, s2),
                                    "input 16 B in": (offset_view(xs, 4), s1, s2)}
                        if axis == 1:
                            variants["scales 4 B in"] = (xs, offset_view(s1, 1), offset_view(s2, 1))
                        if stack == 1:
                            variants["2-D"] = (xs[0], s1, s2)
                        for xv, v1, v2 in variants.values():
                            x3 = xv if xv.ndim == 3 else xv[None]
                            want = rc.residue_cast_plain(x3, v1, v2, **kw)
                            self.compare("residue_cast", lambda: rc.residue_cast(xv, v1, v2, **kw),
                                         lambda: want if xv.ndim == 3 else want[0])
                    print(f"  residue_cast S={stack} {m}x{k} N={n_mod} n_limbs={nl}: == plain for both scale "
                          f"axes, on aligned and offset views, bitwise", flush=True)
        if limbs_seen != {1, 2, 3, 4}:
            raise AssertionError(f"residue_cast checks covered n_limbs {sorted(limbs_seen)}, expected 1-4")
        x = torch.from_numpy(phi_matrix(self.rng, (64, 64), PHI, np.float32)).to(self.dev)[None]
        one = torch.ones(64, dtype=torch.float32, device=self.dev)
        before = rc.residue_cast.launches
        for bad in ((4,), (3,), (257,), (255, 254)):
            try:
                rc.residue_cast(x, one, one, moduli=bad, n_limbs=1)
            except ValueError:
                pass
            else:
                raise AssertionError(f"residue_cast: moduli {bad} were not refused on the card")
            mods = np.ascontiguousarray(bad, dtype=np.int32)
            radix = np.ascontiguousarray(limb_radix_f32(bad, 1))
            out = torch.empty((1, len(bad), 64, 64), dtype=torch.int8, device=self.dev)
            status = rc._entry()(x.data_ptr(), one.data_ptr(), one.data_ptr(), out.data_ptr(), 1, 64, 64, 0,
                                 len(bad), 1, mods.ctypes.data, radix.ctypes.data,
                                 torch.cuda.current_stream().cuda_stream)
            if status == 0:
                raise AssertionError(f"residue_cast: the C entry launched on moduli {bad}")
        if rc.residue_cast.launches != before:
            raise AssertionError("residue_cast: a refused modulus was counted as a launch")
        print("  residue_cast: moduli 4, 3, 257 and (255, 254) refused by the wrapper (ValueError) and by "
              "the C entry (cudaErrorInvalidValue)", flush=True)

    def fp8_worst_case(self):
        """Both e4m3 kernels at k = FP8_K_CHUNK_LIMIT, m = n = 128, N = 8, on
        planes of -120 (hi = -8, lo = 8: the largest digit product in every
        term), of alternating signs, and random; against their plain
        versions and the int8 kernels.  |r| <= 127 lies inside the kernels'
        exactness proof whatever p, so all of them give the exact sym_mod."""
        from repro_torch.core.moduli import make_crt_context

        _, ig, kf, _ = self.mods
        f8 = self.f8
        mods = make_crt_context(8).moduli
        k = f8.FP8_K_CHUNK_LIMIT
        full_a = torch.full((8, 128, k), -120, dtype=torch.int8, device=self.dev)
        full_b = torch.full((8, k, 128), -120, dtype=torch.int8, device=self.dev)
        alt_b = full_b.clone()
        alt_b[:, ::2, :] = 120
        cases = {
            "-120": (full_a, full_b),
            "alternating": (full_a, alt_b),
            "random": (self.residues(mods, (128, k)), self.residues(mods, (k, 128))),
        }
        for label, (a, b) in cases.items():
            what = f"worst case 128x{k}x128 N=8 {label}"
            got = self.compare("fp8_mod_gemm", lambda: f8.fp8_mod_gemm_batched(a, b, moduli=mods),
                               lambda: f8.fp8_mod_gemm_plain(a, b, moduli=mods))
            self.same_as_int8("fp8_mod_gemm", got, ig.int8_mod_gemm_batched(a, b, moduli=mods), what)
            za, zb = torch.zeros_like(a), torch.zeros_like(b)
            got = self.compare(
                "fp8_karatsuba", lambda: f8.fp8_karatsuba_mod_gemm_batched(a, za, b, zb, moduli=mods),
                lambda: f8.fp8_karatsuba_mod_gemm_plain(a, za, b, zb, moduli=mods))
            self.same_as_int8("fp8_karatsuba", got,
                              kf.karatsuba_mod_gemm_batched(a, za, b, zb, moduli=mods), what)
            print(f"  fp8 {what}: == plain == int8, bitwise", flush=True)

    def residues(self, moduli, shape, offset=0):
        """Random canonical residue planes on the card; with `offset`, a
        contiguous view that many bytes into its storage."""
        planes = [self.rng.integers(-((p - 1) // 2), (p - 1) // 2 + 1, size=shape) for p in moduli]
        x = torch.from_numpy(np.stack(planes).astype(np.int8)).to(self.dev)
        if not offset:
            return x
        buf = torch.empty(x.numel() + offset, dtype=torch.int8, device=self.dev)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        return view

    def int_mm_yardstick(self, name, planes):
        """torch._int_mm over the same int8 (m,k)x(k,n) planes: the products
        alone, without the mod epilogue (a yardstick, not the function)."""
        ms = cuda_ms(lambda: [torch._int_mm(a, b) for a, b in planes], 3)
        self.record[name]["int_mm_ms"] = ms
        print(f"  {name}: torch._int_mm over the same {len(planes)} int8 products "
              f"(product-only yardstick) ms={ms:.4f}", flush=True)

    def megakernels(self, shape, dtype, n_mod, *, chunk_limit, timed, all_tiles=False):
        """The megakernel of `dtype` against its plain version, bitwise, with
        raw and prepared B and f32 and double-single output, and against the
        4-launch kernel composition of the same GEMM; with `all_tiles`, for
        every compiled tile.  With `timed`, the main path's variant (raw B;
        double-single for complex) is timed beside its plain version and
        that composition (the yardstick), and each other tile is timed and
        held to the default tile's output."""
        from repro_torch.core import scaling
        from repro_torch.core.moduli import make_crt_context
        from repro_torch.core.plan import n_limbs_for_ctx
        from repro_torch.kernels.common import split_scale_exponent

        rc, ig, kf, cg = self.mods
        m, k, n = shape
        ctx = make_crt_context(n_mod)
        nl = n_limbs_for_ctx(ctx)
        mods = ctx.moduli
        a = torch.from_numpy(phi_matrix(self.rng, (m, k), PHI, dtype)).to(self.dev)
        b = torch.from_numpy(phi_matrix(self.rng, (k, n), PHI, dtype)).to(self.dev)
        complex_ = a.is_complex()
        if complex_:
            e_mu, e_nu = scaling.scale_fast_complex(a.real, a.imag, b.real, b.imag, ctx)
            xa = torch.stack([a.real, a.imag]).float()
            xb = torch.stack([b.real, b.imag]).float()
        else:
            e_mu, e_nu = scaling.scale_fast_real(a, b, ctx)
            xa, xb = a.float()[None], b.float()[None]
        sa, sb = split_scale_exponent(e_mu), split_scale_exponent(e_nu)
        cast = dict(moduli=mods, n_limbs=nl)
        planes = rc.residue_cast(xb, *sb, scale_axis=1, **cast)  # prepared B
        name = "fused_karatsuba" if complex_ else "fused_mod_gemm"
        label = f"{m}x{k}x{n} N={n_mod} {'complex' if complex_ else 'real'}"

        def composed(out_dd):
            """The same GEMM as cast, cast, product, Garner: 4 launches."""
            ares = rc.residue_cast(xa, *sa, scale_axis=0, **cast)
            bres = rc.residue_cast(xb, *sb, scale_axis=1, **cast)
            if complex_:
                e_res = torch.stack(kf.karatsuba_mod_gemm_batched(
                    ares[0], ares[1], bres[0], bres[1], moduli=mods))
            else:
                e_res = ig.int8_mod_gemm_batched(ares[0], bres[0], moduli=mods)[None]
            out = cg.crt_garner(e_res, e_mu, e_nu, ctx, out_dd=out_dd)
            return (out[0], out[1]) if complex_ else out[0]

        for tile in self.tiles_of[name] if all_tiles else (None,):
            for out_dd in (False, True):
                for prepared in (False, True):
                    main = not prepared and out_dd == complex_
                    if timed and not main:
                        continue
                    kw = dict(n_limbs=nl, out_dd=out_dd, chunk_limit=chunk_limit)
                    if complex_:
                        rhs = (None, None) if prepared else (xb[0], xb[1])
                        kw["b_res"] = (planes[0], planes[1]) if prepared else None

                        def kernel(tile=tile, rhs=rhs, kw=kw):
                            return kf.fused_karatsuba_mod_gemm(xa[0], xa[1], *rhs, e_mu, e_nu, ctx,
                                                               tile=tile, **kw)

                        plain = lambda: kf.fused_karatsuba_mod_gemm_plain(xa[0], xa[1], *rhs, e_mu, e_nu, ctx, **kw)  # noqa: E731
                        ops = 3 * 2 * n_mod * m * n * k
                        b_bytes = 2 * (n_mod * k * n if prepared else 4 * k * n)
                        nbytes = 2 * 4 * m * k + b_bytes + 2 * (8 if out_dd else 4) * m * n
                    else:
                        rhs = None if prepared else xb[0]
                        kw["b_res"] = planes[0] if prepared else None

                        def kernel(tile=tile, rhs=rhs, kw=kw):
                            return ig.fused_mod_gemm(xa[0], rhs, e_mu, e_nu, ctx, tile=tile, **kw)

                        plain = lambda: ig.fused_mod_gemm_plain(xa[0], rhs, e_mu, e_nu, ctx, **kw)  # noqa: E731
                        ops = 2 * n_mod * m * n * k
                        b_bytes = n_mod * k * n if prepared else 4 * k * n
                        nbytes = 4 * m * k + b_bytes + (8 if out_dd else 4) * m * n
                    t = None
                    if timed:
                        t = (f"{label} out_dd={out_dd}", nbytes + 16 * (m + n), ops, INT8_OPS_S, 3)
                    got = self.compare(name, kernel, plain, timed=t)
                    if not prepared:
                        want = composed(out_dd)
                        pairs = zip(got, want) if complex_ else [(got, want)]
                        if not all(same_bits(g, w) for g, w in pairs):
                            raise AssertionError(f"{name} {label} tile {tile}: the megakernel differs "
                                                 "from the 4-launch composition")
                    if all_tiles:
                        print(f"  {name} tile {tile_label(tile)} {label} chunk_limit={chunk_limit} "
                              f"out_dd={out_dd} prepared={prepared}: == plain, bitwise", flush=True)
                    if timed:
                        self.default_tile_ms(name)
                        for other in self.other_tiles(name):
                            self.time_tile(name, other, lambda: kernel(tile=other), got, 1)
                        ms = cuda_ms(lambda: composed(out_dd), 3)
                        self.record[name]["kernel_path_ms"] = ms
                        print(f"  {name}: the same GEMM as 4 launches (cast, cast, product, Garner; "
                              f"the yardstick) ms={ms:.4f}", flush=True)

    def chain(self, shape, dtype, n_mod, timed):
        from repro_torch.core import scaling
        from repro_torch.core.moduli import make_crt_context
        from repro_torch.core.plan import n_limbs_for_ctx
        from repro_torch.kernels.common import plane_mod_params, split_scale_exponent, sym_mod_f32

        rc, ig, kf, cg = self.mods
        m, k, n = shape
        ctx = make_crt_context(n_mod)
        nl = n_limbs_for_ctx(ctx)
        mods = ctx.moduli
        a = torch.from_numpy(phi_matrix(self.rng, (m, k), PHI, dtype)).to(self.dev)
        b = torch.from_numpy(phi_matrix(self.rng, (k, n), PHI, dtype)).to(self.dev)
        complex_ = a.is_complex()
        if complex_:
            e_mu, e_nu = scaling.scale_fast_complex(a.real, a.imag, b.real, b.imag, ctx)
            xa = torch.stack([a.real, a.imag]).float()
            xb = torch.stack([b.real, b.imag]).float()
        else:
            e_mu, e_nu = scaling.scale_fast_real(a, b, ctx)
            xa, xb = a.float()[None], b.float()[None]
        s = xa.shape[0]
        label = f"{m}x{k}x{n} N={n_mod} {'complex' if complex_ else 'real'}"

        def cast(x, e, axis, t=None):
            s1, s2 = split_scale_exponent(e)
            kw = dict(moduli=mods, n_limbs=nl, scale_axis=axis)
            return self.compare(
                "residue_cast",
                lambda: rc.residue_cast(x, s1, s2, **kw),
                lambda: rc.residue_cast_plain(x, s1, s2, **kw),
                timed=t,
            )

        rows, cols = xa.shape[1:]
        cast_t = None
        if timed:
            numel = s * rows * cols
            cast_t = (f"S={s} {rows}x{cols} N={n_mod} (A, row scales)", numel * (4 + n_mod) + 8 * rows,
                      numel * cast_flops(n_mod, nl), F32_OPS_S, 20)
        ares = cast(xa, e_mu, 0, cast_t)
        bres = cast(xb, e_nu, 1)
        if timed:
            s1, s2 = split_scale_exponent(e_nu)
            rec = self.record["residue_cast"]
            rec["cols_ms"] = cuda_ms(lambda: rc.residue_cast(xb, s1, s2, moduli=mods, n_limbs=nl, scale_axis=1), 20)
            print(f"  residue_cast S={s} {xb.shape[1]}x{xb.shape[2]} N={n_mod} (B, column scales): "
                  f"kernel_ms={rec['cols_ms']:.4f}", flush=True)

        if complex_:
            arr, ari = ares[0], ares[1]
            brr, bri = bres[0], bres[1]
            prod_t = None
            if timed:
                prod_t = (label, n_mod * (2 * m * k + 2 * k * n + 2 * m * n),
                          3 * 2 * n_mod * m * n * k, INT8_OPS_S, 5)
            first = self.compare(
                "karatsuba_fused",
                lambda: kf.karatsuba_mod_gemm_batched(arr, ari, brr, bri, moduli=mods),
                lambda: kf.karatsuba_mod_gemm_plain(arr, ari, brr, bri, moduli=mods),
                timed=prod_t,
            )
            second = self.compare(
                "karatsuba_fused",
                lambda: kf.karatsuba_mod_gemm_batched(arr, ari, brr, bri, moduli=mods, carry=first),
                lambda: kf.karatsuba_mod_gemm_plain(arr, ari, brr, bri, moduli=mods, carry=first),
            )
            if timed:
                self.default_tile_ms("karatsuba_fused")
                for tile in self.other_tiles("karatsuba_fused"):
                    self.time_tile("karatsuba_fused", tile, lambda: kf.karatsuba_mod_gemm_batched(
                        arr, ari, brr, bri, moduli=mods, tile=tile), first, 5)
                self.int_mm_yardstick("karatsuba_fused", [
                    (x[l], y[l]) for l in range(n_mod) for x, y in ((arr, brr), (ari, bri), (arr, bri))])
            f8 = self.f8
            fp8_t = None
            if timed:
                fp8_t = (label, n_mod * (2 * m * k + 2 * k * n + 2 * m * n),
                         24 * n_mod * m * n * k, FP8_OPS_S, 3)
            for carry, want in ((None, first), (first, second)):
                got = self.compare(
                    "fp8_karatsuba",
                    lambda: f8.fp8_karatsuba_mod_gemm_batched(arr, ari, brr, bri, moduli=mods, carry=carry),
                    lambda: f8.fp8_karatsuba_mod_gemm_plain(arr, ari, brr, bri, moduli=mods, carry=carry),
                    timed=fp8_t if carry is None else None,
                )
                self.same_as_int8("fp8_karatsuba", got, want, f"{label} carry={carry is not None}")
            if timed:
                self.default_tile_ms("fp8_karatsuba")
                for tile in self.other_tiles("fp8_karatsuba"):
                    self.time_tile("fp8_karatsuba", tile, lambda: f8.fp8_karatsuba_mod_gemm_batched(
                        arr, ari, brr, bri, moduli=mods, tile=tile), first, 3)
                pf, half, _ = plane_mod_params(mods, self.dev)
                s_a, s_b = (sym_mod_f32(x.float() + y.float(), pf, half).to(torch.int8)
                            for x, y in ((arr, ari), (brr, bri)))  # the F operands
                self.scaled_mm_yardstick("fp8_karatsuba", [
                    (x[l], y[l]) for l in range(n_mod) for x, y in ((arr, brr), (ari, bri), (s_a, s_b))])
            e_res = torch.stack(first)
        else:
            prod_t = None
            if timed:
                prod_t = (label, n_mod * (m * k + k * n + m * n), 2 * n_mod * m * n * k, INT8_OPS_S, 5)
            first = self.compare(
                "int8_mod_gemm",
                lambda: ig.int8_mod_gemm_batched(ares[0], bres[0], moduli=mods),
                lambda: ig.int8_mod_gemm_plain(ares[0], bres[0], moduli=mods),
                timed=prod_t,
            )
            second = self.compare(
                "int8_mod_gemm",
                lambda: ig.int8_mod_gemm_batched(ares[0], bres[0], moduli=mods, carry=first),
                lambda: ig.int8_mod_gemm_plain(ares[0], bres[0], moduli=mods, carry=first),
            )
            if timed:
                self.default_tile_ms("int8_mod_gemm")
                for tile in self.other_tiles("int8_mod_gemm"):
                    self.time_tile("int8_mod_gemm", tile, lambda: ig.int8_mod_gemm_batched(
                        ares[0], bres[0], moduli=mods, tile=tile), first, 5)
                self.int_mm_yardstick("int8_mod_gemm", [(ares[0][l], bres[0][l]) for l in range(n_mod)])
                self.int8_global_ms(mods, m, k, n)
            f8 = self.f8
            fp8_t = None
            if timed:
                fp8_t = (label, n_mod * (m * k + k * n + m * n), 8 * n_mod * m * n * k, FP8_OPS_S, 3)
            for carry, want in ((None, first), (first, second)):
                got = self.compare(
                    "fp8_mod_gemm",
                    lambda: f8.fp8_mod_gemm_batched(ares[0], bres[0], moduli=mods, carry=carry),
                    lambda: f8.fp8_mod_gemm_plain(ares[0], bres[0], moduli=mods, carry=carry),
                    timed=fp8_t if carry is None else None,
                )
                self.same_as_int8("fp8_mod_gemm", got, want, f"{label} carry={carry is not None}")
            if timed:
                self.default_tile_ms("fp8_mod_gemm")
                for tile in self.other_tiles("fp8_mod_gemm"):
                    self.time_tile("fp8_mod_gemm", tile, lambda: f8.fp8_mod_gemm_batched(
                        ares[0], bres[0], moduli=mods, tile=tile), first, 3)
                self.scaled_mm_yardstick("fp8_mod_gemm", [(ares[0][l], bres[0][l]) for l in range(n_mod)])
            e_res = first[None]

        for out_dd in (complex_, not complex_):
            garner_t = None
            if timed and out_dd == complex_:
                numel = e_res.shape[0] * m * n
                garner_t = (f"S={e_res.shape[0]} {m}x{n} N={n_mod} out_dd={out_dd}",
                            numel * (n_mod + (8 if out_dd else 4)) + 8 * (m + n),
                            numel * garner_flops(n_mod, out_dd), F32_OPS_S, 10)
            self.compare(
                "crt_garner",
                lambda: cg.crt_garner(e_res, e_mu, e_nu, ctx, out_dd=out_dd),
                lambda: cg.crt_garner_plain(e_res, e_mu, e_nu, ctx, out_dd=out_dd),
                timed=garner_t,
            )


ROUTINES = {"sgemm": np.float32, "dgemm": np.float64, "cgemm": np.complex64, "zgemm": np.complex128}


def end_to_end_cpu_parity(rng, dev, GemmPolicy, linalg):
    """Phase 3(a): SMALL^3 on the card (device=None) bitwise equal to device='cpu'."""
    for routine, dtype in ROUTINES.items():
        a = phi_matrix(rng, (SMALL, SMALL), PHI, dtype)
        b = phi_matrix(rng, (SMALL, SMALL), PHI, dtype)
        complex_ = np.issubdtype(dtype, np.complexfloating)
        forms = ("karatsuba", "block_a", "block_b") if complex_ else ("karatsuba",)
        modes = ("fast", "accu")
        cases = [(ex, mode, "karatsuba", "auto") for ex in ("kernel", "fused", "fp8") for mode in modes]
        if complex_:
            cases += [(ex, "fast", form, "auto") for ex in ("fused", "fp8") for form in ("block_a", "block_b")]
        # the reference execution with every CRT method, and the per-modulus one
        cases += [("reference", mode, form, method) for mode in modes for form in forms
                  for method in ("paper", "dd", "garner")]
        cases += [("per_modulus_kernel", mode, form, "auto") for mode in modes for form in forms[:2]]
        for execution, mode, formulation, method in cases:
            pol = GemmPolicy(execution=execution, mode=mode, formulation=formulation, method=method)
            on_card = getattr(linalg, routine)(a, b, policy=pol)
            on_cpu = getattr(linalg, routine)(a, b, policy=pol, device="cpu")
            what = (f"{routine} {execution} {mode} {formulation if complex_ else 'real'}"
                    f"{' ' + method if execution == 'reference' else ''} {SMALL}^3")
            if on_card.device.type != dev.type or not same_bits(on_card.cpu(), on_cpu):
                raise AssertionError(f"{what}: the card differs from device='cpu'")
            print(f"  {what}: card == cpu, bitwise", flush=True)


def rel_error(y, a, b):
    """max|C - C_ref| / max|C_ref| against torch.matmul in float64/complex128."""
    wide = torch.complex128 if a.is_complex() else torch.float64
    ref = torch.matmul(a.to(wide), b.to(wide))
    return float((y.to(wide) - ref).abs().max() / ref.abs().max())


def timed_calls(fn, reps):
    """(last result, mean host-clock ms) of `reps` calls ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        y = fn()
    torch.cuda.synchronize()
    return y, (time.perf_counter() - t0) / reps * 1e3


def check_launches(kernels, before, expect, calls, what, model):
    """The launches since `before`: `expect` per GEMM by kernel, and in all
    `model` per GEMM, the port's `perfmodel.kernel_launch_count`."""
    delta = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    want = {k: expect.get(k, 0) * calls for k in delta}
    if delta != want:
        raise AssertionError(f"{what}: launches {delta} for {calls} GEMMs, expected {want}")
    if sum(delta.values()) != model * calls:
        raise AssertionError(f"{what}: {sum(delta.values())} launches for {calls} GEMMs, "
                             f"perfmodel.kernel_launch_count says {model} each")


def model_launches(execution, n_moduli, complex_, prepared=False):
    """`perfmodel.kernel_launch_count` of one fast-mode GEMM on `execution`."""
    from repro_torch.core import perfmodel

    return perfmodel.kernel_launch_count(
        n_moduli, "karatsuba" if complex_ else "real", modulus_batched=True,
        fused_karatsuba=True, prepared=prepared, fused=execution == "fused")


def default_moduli(tensor):
    from repro_torch.core.plan import default_n_moduli

    return default_n_moduli(tensor.dtype, "fast")


def main_path(rng, dev, GemmPolicy, linalg, kernels):
    """Phase 3(b): the kernel main path, with the launch counters.  Returns
    the counts and each run's operands, output and times for phase 3(c)."""
    expect_real = {"residue_cast": 2, "int8_mod_gemm": 1, "crt_garner": 1}
    expect_complex = {"residue_cast": 2, "karatsuba_fused": 1, "crt_garner": 1}
    runs = [(routine, dtype, MAIN) for routine, dtype in ROUTINES.items()]
    runs.append(("zgemm", np.complex128, BIG))
    pol = GemmPolicy(execution="kernel", mode="fast")
    results = []
    for routine, dtype, size in runs:
        a = torch.from_numpy(phi_matrix(rng, (size, size), PHI, dtype)).to(dev)
        b = torch.from_numpy(phi_matrix(rng, (size, size), PHI, dtype)).to(dev)
        results.append({"routine": routine, "size": size, "a": a, "b": b})
    torch.cuda.synchronize()

    kernels.reset_launches()
    for r in results:
        routine, size, a, b = r["routine"], r["size"], r["a"], r["b"]
        fn = getattr(linalg, routine)
        reps = 3 if size < BIG else 1
        before = kernels.launch_counts()
        fn(a, b, policy=pol)
        y, emu_ms = timed_calls(lambda: fn(a, b, policy=pol), reps)
        check_launches(kernels, before, expect_complex if a.is_complex() else expect_real,
                       1 + reps, f"{routine} {size}^3",
                       model_launches("kernel", default_moduli(a), a.is_complex()))
        native_ms = cuda_ms(lambda: torch.matmul(a, b), reps)
        rel = rel_error(y, a, b)
        flops = (8 if a.is_complex() else 2) * size**3
        r.update(y=y, kernel_ms=emu_ms, native_ms=native_ms, flops=flops)
        print(f"  {routine} {size}^3 fast: emulated_ms={emu_ms:.3f} ({flops / emu_ms / 1e9:.2f} TFLOPS) "
              f"torch.matmul_ms={native_ms:.3f} ({flops / native_ms / 1e9:.2f} TFLOPS) "
              f"speedup={native_ms / emu_ms:.3f} rel_err={rel:.3e} launches/GEMM=4", flush=True)
        if not rel < 1e-4:
            raise AssertionError(f"{routine} {size}^3: relative error {rel} >= 1e-4")
    counts = kernels.launch_counts()
    for name in ("residue_cast", "int8_mod_gemm", "karatsuba_fused", "crt_garner"):
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the kernel main path")
    return counts, results


def fused_main_path(results, GemmPolicy, linalg, kernels):
    """Phase 3(c): the same GEMMs on the fused execution: 1 launch each,
    bitwise equal to the kernel execution's output."""
    pol = GemmPolicy(execution="fused", mode="fast")
    kernels.reset_launches()
    for r in results:
        routine, size, a, b = r["routine"], r["size"], r["a"], r["b"]
        fn = getattr(linalg, routine)
        reps = 3 if size < BIG else 1
        before = kernels.launch_counts()
        first = fn(a, b, policy=pol)
        y, ms = timed_calls(lambda: fn(a, b, policy=pol), reps)
        expect = {"fused_karatsuba" if a.is_complex() else "fused_mod_gemm": 1}
        check_launches(kernels, before, expect, 1 + reps, f"fused {routine} {size}^3",
                       model_launches("fused", default_moduli(a), a.is_complex()))
        r["fused_ms"] = ms
        if not (same_bits(first, r["y"]) and same_bits(y, r["y"])):
            raise AssertionError(f"fused {routine} {size}^3: differs from the kernel execution")
        rel = rel_error(y, a, b)
        flops = r["flops"]
        print(f"  {routine} {size}^3 fast fused: emulated_ms={ms:.3f} ({flops / ms / 1e9:.2f} TFLOPS) "
              f"kernel_execution_ms={r['kernel_ms']:.3f} torch.matmul_ms={r['native_ms']:.3f} "
              f"speedup_vs_cublas={r['native_ms'] / ms:.3f} rel_err={rel:.3e} launches/GEMM=1 "
              f"== kernel execution, bitwise", flush=True)
        if not rel < 1e-4:
            raise AssertionError(f"fused {routine} {size}^3: relative error {rel} >= 1e-4")
    counts = kernels.launch_counts()
    for name in ("fused_mod_gemm", "fused_karatsuba"):
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the fused main path")
    return counts


def launch_bound_sgemm(rng, dev, GemmPolicy, linalg):
    """Phase 3c, after the fused main path's counts are read: sgemm at
    LAUNCH_BOUND_SIZES, where launches weigh most, on `fused` (1 launch)
    and on `kernel` (4), bitwise equal, each timed over LAUNCH_BOUND_REPS
    calls (host clock, synchronized).  Returns {size: (fused_ms, kernel_ms)}."""
    out = {}
    for size in LAUNCH_BOUND_SIZES:
        a = torch.from_numpy(phi_matrix(rng, (size, size), PHI, np.float32)).to(dev)
        b = torch.from_numpy(phi_matrix(rng, (size, size), PHI, np.float32)).to(dev)
        ys, ms = {}, {}
        for execution in ("fused", "kernel", "kernel", "fused"):
            pol = GemmPolicy(execution=execution, mode="fast")
            linalg.sgemm(a, b, policy=pol)
            ys[execution], t = timed_calls(lambda: linalg.sgemm(a, b, policy=pol), LAUNCH_BOUND_REPS)
            ms.setdefault(execution, []).append(t)
        if not same_bits(ys["fused"], ys["kernel"]):
            raise AssertionError(f"sgemm {size}^3: fused differs from kernel")
        out[size] = (min(ms["fused"]), min(ms["kernel"]))
        print(f"  sgemm {size}^3 fast: fused_ms={out[size][0]:.4f} (1 launch) kernel_ms={out[size][1]:.4f} "
              f"(4 launches) fused/kernel={out[size][0] / out[size][1]:.3f}, bitwise equal "
              f"(each the better of two runs of {LAUNCH_BOUND_REPS} calls)", flush=True)
    return out


def fp8_main_path(results, GemmPolicy, linalg, kernels):
    """Phase 3(d): the same GEMMs on the fp8 execution: 4 launches each (the
    product on an e4m3 kernel), bitwise equal to the kernel execution."""
    pol = GemmPolicy(execution="fp8", mode="fast")
    kernels.reset_launches()
    for r in results:
        routine, size, a, b = r["routine"], r["size"], r["a"], r["b"]
        fn = getattr(linalg, routine)
        reps = 3 if size < BIG else 1
        before = kernels.launch_counts()
        first = fn(a, b, policy=pol)
        y, ms = timed_calls(lambda: fn(a, b, policy=pol), reps)
        product = "fp8_karatsuba" if a.is_complex() else "fp8_mod_gemm"
        check_launches(kernels, before, {"residue_cast": 2, product: 1, "crt_garner": 1}, 1 + reps,
                       f"fp8 {routine} {size}^3",
                       model_launches("fp8", default_moduli(a), a.is_complex()))
        r["fp8_ms"] = ms
        if not (same_bits(first, r["y"]) and same_bits(y, r["y"])):
            raise AssertionError(f"fp8 {routine} {size}^3: differs from the kernel execution")
        rel = rel_error(y, a, b)
        flops = r["flops"]
        print(f"  {routine} {size}^3 fast fp8: emulated_ms={ms:.3f} ({flops / ms / 1e9:.2f} TFLOPS) "
              f"kernel_execution_ms={r['kernel_ms']:.3f} torch.matmul_ms={r['native_ms']:.3f} "
              f"speedup_vs_cublas={r['native_ms'] / ms:.3f} rel_err={rel:.3e} launches/GEMM=4 "
              f"== kernel execution, bitwise", flush=True)
        if not rel < 1e-4:
            raise AssertionError(f"fp8 {routine} {size}^3: relative error {rel} >= 1e-4")
    counts = kernels.launch_counts()
    for name in ("fp8_mod_gemm", "fp8_karatsuba"):
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the fp8 main path")
    return counts


def sampled_error(y, a, b):
    """`core.accuracy.rel_error` (the metric `rel_bound` certifies) on
    REF_ROWS[complex] evenly spaced rows, against numpy's extended-precision
    product of those rows (64-bit significands, on the host)."""
    from repro_torch.core import accuracy

    rows = torch.linspace(0, a.shape[0] - 1, REF_ROWS[a.is_complex()]).round().long().to(a.device)
    ld = np.clongdouble if a.is_complex() else np.longdouble
    ref = a[rows].cpu().numpy().astype(ld) @ b.cpu().numpy().astype(ld)
    ref = torch.from_numpy(ref.astype(np.complex128 if a.is_complex() else np.float64))
    return accuracy.rel_error(y[rows].cpu(), ref, a[rows].cpu(), b.cpu()), len(rows)


def reference_main_path(results, GemmPolicy, linalg, kernels):
    """Phase 3(e): the reference execution (plain PyTorch in float64, no
    hand-written kernel) on phase 3(b)'s operands: no launch, s/cgemm
    bitwise equal to the kernel execution, d/zgemm within `rel_bound`."""
    from repro_torch.core import accuracy

    pol = GemmPolicy(execution="reference", mode="fast")
    kernels.reset_launches()
    for r in results:
        routine, size, a, b = r["routine"], r["size"], r["a"], r["b"]
        fn = getattr(linalg, routine)
        first = fn(a, b, policy=pol)
        y, ms = timed_calls(lambda: fn(a, b, policy=pol), 3)
        if any(kernels.launch_counts().values()):
            raise AssertionError(f"reference {routine} {size}^3: kernel launches {kernels.launch_counts()}")
        if not same_bits(first, y):
            raise AssertionError(f"reference {routine} {size}^3: two calls differ")
        r["reference_ms"] = ms
        if routine in ("sgemm", "cgemm"):
            if not same_bits(y, r["y"]):
                raise AssertionError(f"reference {routine} {size}^3: differs from the kernel execution")
            check = "== kernel execution, bitwise"
        else:
            n_mod = default_moduli(a)
            err, rows = sampled_error(y, a, b)
            bound = accuracy.rel_bound(str(a.dtype).removeprefix("torch."), "fast", n_mod, size,
                                       formulation="karatsuba" if a.is_complex() else None)
            if not err <= bound:
                raise AssertionError(f"reference {routine} {size}^3: error {err} over rel_bound {bound}")
            check = (f"componentwise_err={err:.3e} <= rel_bound(N={n_mod})={bound:.3e} "
                     f"on {rows} rows against extended precision")
        flops = r["flops"]
        print(f"  {routine} {size}^3 fast reference: emulated_ms={ms:.3f} ({flops / ms / 1e9:.2f} TFLOPS) "
              f"kernel_execution_ms={r['kernel_ms']:.3f} torch.matmul_ms={r['native_ms']:.3f} "
              f"rel_err={rel_error(y, a, b):.3e} launches/GEMM=0 {check}", flush=True)


def product_wrapper(kernels, complex_):
    """The residue-product kernel wrapper of the kernel and per-modulus executions."""
    if complex_:
        return kernels.karatsuba_fused.karatsuba_mod_gemm_batched
    return kernels.int8_mod_gemm.int8_mod_gemm_batched


def per_modulus_path(rng, dev, results, GemmPolicy, linalg, kernels):
    """Phase 3(f): the per-modulus execution on phase 3(b)'s operands (one
    product launch per modulus, on a grid of one plane), bitwise equal to
    the kernel execution, with `kernel_launch_count(modulus_batched=False)`
    launches; then at RAGGED (global loads) and ALIGNED_RAGGED (TMA).
    Returns the 4096^3 run's launch counts."""
    from repro_torch.core import perfmodel

    pol = GemmPolicy(execution="per_modulus_kernel", mode="fast")
    kernels.reset_launches()
    for r in results:
        routine, size, a, b = r["routine"], r["size"], r["a"], r["b"]
        fn = getattr(linalg, routine)
        cx, n_mod = a.is_complex(), default_moduli(a)
        product = product_wrapper(kernels, cx)
        expect = {"residue_cast": 4 if cx else 2, "karatsuba_fused" if cx else "int8_mod_gemm": n_mod,
                  "crt_garner": 2 if cx else 1}
        model = perfmodel.kernel_launch_count(n_mod, "karatsuba" if cx else "real", modulus_batched=False,
                                              fused_karatsuba=True)
        before, tma0 = kernels.launch_counts(), product.tma_launches
        first = fn(a, b, policy=pol)
        y, ms = timed_calls(lambda: fn(a, b, policy=pol), 3)
        what = f"per_modulus_kernel {routine} {size}^3"
        check_launches(kernels, before, expect, 4, what, model)
        if product.tma_launches - tma0 != 4 * n_mod:
            raise AssertionError(f"{what}: {product.tma_launches - tma0} of {4 * n_mod} product launches by TMA")
        if not (same_bits(first, r["y"]) and same_bits(y, r["y"])):
            raise AssertionError(f"{what}: differs from the kernel execution")
        r["per_modulus_ms"] = ms
        flops = r["flops"]
        print(f"  {routine} {size}^3 fast per_modulus_kernel: emulated_ms={ms:.3f} ({flops / ms / 1e9:.2f} TFLOPS) "
              f"kernel_execution_ms={r['kernel_ms']:.3f} torch.matmul_ms={r['native_ms']:.3f} "
              f"launches/GEMM={model} ({expect}, products all by TMA) == kernel execution, bitwise", flush=True)
    counts = kernels.launch_counts()
    for shape, by_tma in ((RAGGED, False), (ALIGNED_RAGGED, True)):
        m, k, n = shape
        for routine, dtype in (("sgemm", np.float32), ("zgemm", np.complex128)):
            a = torch.from_numpy(phi_matrix(rng, (m, k), PHI, dtype)).to(dev)
            b = torch.from_numpy(phi_matrix(rng, (k, n), PHI, dtype)).to(dev)
            fn = getattr(linalg, routine)
            product = product_wrapper(kernels, a.is_complex())
            n_mod = default_moduli(a)
            launches0, tma0 = product.launches, product.tma_launches
            y = fn(a, b, policy=pol)
            launches, tma = product.launches - launches0, product.tma_launches - tma0
            what = f"per_modulus_kernel {routine} {m}x{k}x{n} N={n_mod}"
            if launches != n_mod or tma != (n_mod if by_tma else 0):
                raise AssertionError(f"{what}: {launches} product launches, {tma} by TMA")
            if not same_bits(y, fn(a, b, policy=GemmPolicy(execution="kernel", mode="fast"))):
                raise AssertionError(f"{what}: differs from the kernel execution")
            print(f"  {what}: {launches} one-plane product launches, {tma} by TMA "
                  f"({'TMA' if by_tma else 'global-load'} path) == kernel execution, bitwise", flush=True)
    return counts


def adjoint(x):
    """The operand of a cotangent product as the backward forms it:
    transposed, and conjugated for complex x."""
    x = x.detach().transpose(-1, -2)
    return x.conj_physical() if x.is_complex() else x


def grads(fn, a, b, g, pol, device=None):
    """(y, x.grad, w.grad) of fn(x, w) backward with cotangent g on `device`."""
    x = a.detach().clone().requires_grad_()
    w = b.detach().clone().requires_grad_()
    y = fn(x, w, policy=pol, device=device)
    y.backward(g if device is None else g.to(device))
    return y.detach(), x.grad, w.grad


def backward_path(rng, dev, results, GemmPolicy, linalg, kernels):
    """Phase 3(g): the emulated matmul's backward.  sgemm and zgemm at
    MAIN^3 on `kernel` with requires_grad on both operands: exactly 12
    launches (three GEMMs of four), the gradients bitwise equal to the
    forward calls on (g, w^T) and (x^T, g) (w^H and x^H for zgemm), timed
    beside the forward; at SMALL^3 also on `reference` and `fused`, the
    card bitwise equal to device='cpu'."""
    pol = GemmPolicy(execution="kernel", mode="fast")
    for r in results:
        routine, size, a, b = r["routine"], r["size"], r["a"], r["b"]
        if routine not in ("sgemm", "zgemm"):
            continue
        fn = getattr(linalg, routine)
        g = torch.from_numpy(phi_matrix(rng, (size, size), PHI, ROUTINES[routine])).to(dev)
        product = "karatsuba_fused" if a.is_complex() else "int8_mod_gemm"
        kernels.reset_launches()
        y, dx, dw = grads(fn, a, b, g, pol)
        counts = {name: c for name, c in kernels.launch_counts().items() if c}
        if counts != {"residue_cast": 6, product: 3, "crt_garner": 3}:
            raise AssertionError(f"backward {routine} {size}^3: launches {counts}, expected three GEMMs of four")
        if not (same_bits(y, r["y"]) and same_bits(dx, fn(g, adjoint(b), policy=pol))
                and same_bits(dw, fn(adjoint(a), g, policy=pol))):
            raise AssertionError(f"backward {routine} {size}^3: a gradient differs from its forward product")
        _, step_ms = timed_calls(lambda: grads(fn, a, b, g, pol), 3)
        print(f"  {routine} {size}^3 fast kernel forward+backward: ms={step_ms:.3f} "
              f"forward_ms={r['kernel_ms']:.3f} ratio={step_ms / r['kernel_ms']:.3f} launches=12 {counts}; "
              f"x.grad == {routine}(g, w{'^H' if a.is_complex() else '^T'}), "
              f"w.grad == {routine}(x{'^H' if a.is_complex() else '^T'}, g), bitwise", flush=True)
    for execution in ("reference", "fused"):
        pol = GemmPolicy(execution=execution, mode="fast")
        for routine in ("sgemm", "zgemm"):
            a, b, g = (torch.from_numpy(phi_matrix(rng, (SMALL, SMALL), PHI, ROUTINES[routine])).to(dev)
                       for _ in range(3))
            fn = getattr(linalg, routine)
            card = grads(fn, a, b, g, pol)
            cpu = grads(fn, a.cpu(), b.cpu(), g.cpu(), pol, device="cpu")
            if not all(same_bits(c.cpu(), h) for c, h in zip(card, cpu)):
                raise AssertionError(f"backward {routine} {execution} {SMALL}^3: the card differs from device='cpu'")
            print(f"  {routine} {execution} {SMALL}^3 forward+backward: y, x.grad, w.grad card == cpu, bitwise",
                  flush=True)


def serving(rng, dev, GemmPolicy, linalg, kernels):
    """Phase 4: prepared-weight serving on the fused and kernel executions."""
    expect = {
        ("fused", True): {"fused_karatsuba": 1},
        ("fused", False): {"fused_mod_gemm": 1},
        ("kernel", True): {"residue_cast": 1, "karatsuba_fused": 1, "crt_garner": 1},
        ("kernel", False): {"residue_cast": 1, "int8_mod_gemm": 1, "crt_garner": 1},
        ("fp8", True): {"residue_cast": 1, "fp8_karatsuba": 1, "crt_garner": 1},
        ("fp8", False): {"residue_cast": 1, "fp8_mod_gemm": 1, "crt_garner": 1},
    }
    for routine, dtype in (("zgemm", np.complex128), ("sgemm", np.float32)):
        w = torch.from_numpy(phi_matrix(rng, (SERVE_N, SERVE_N), PHI, dtype)).to(dev)
        xs = [torch.from_numpy(phi_matrix(rng, (m, SERVE_N), PHI, dtype)).to(dev) for m in SERVE_M]
        fn = getattr(linalg, routine)
        for execution in ("fused", "kernel", "fp8"):
            pol = GemmPolicy(backend=linalg.BACKEND_FOR_DTYPE[np.dtype(dtype).name],
                             execution=execution, mode="fast")
            t0 = time.perf_counter()
            prepared = linalg.prepare_weights({"w": w}, pol)["w"]
            torch.cuda.synchronize()
            prep_ms = (time.perf_counter() - t0) * 1e3
            print(f"  {routine} W {SERVE_N}x{SERVE_N} {execution}: prepare_weights ms={prep_ms:.3f}", flush=True)
            fn(xs[0], prepared, policy=pol)  # warm-up
            for x in xs:
                if execution == "fp8" and x.shape[0] not in SERVE_M_FP8:
                    continue
                before = kernels.launch_counts()
                y, ms = timed_calls(lambda: fn(x, prepared, policy=pol), 1)
                check_launches(kernels, before, expect[execution, w.is_complex()], 1,
                               f"{routine} {execution} prepared m={x.shape[0]}",
                               model_launches(execution, default_moduli(w), w.is_complex(), prepared=True))
                direct, direct_ms = timed_calls(lambda: fn(x, w, policy=pol), 1)
                if not same_bits(y, direct):
                    raise AssertionError(f"{routine} {execution} m={x.shape[0]}: prepared differs from unprepared")
                print(f"  {routine} {execution} request m={x.shape[0]}: prepared_ms={ms:.3f} "
                      f"unprepared_ms={direct_ms:.3f} launches={sum(expect[execution, w.is_complex()].values())} "
                      f"== unprepared, bitwise", flush=True)


def path_expect(execution, complex_):
    """The launches of one fast-mode GEMM on `execution`, by kernel."""
    if execution == "fused":
        return {"fused_karatsuba" if complex_ else "fused_mod_gemm": 1}
    product = {"kernel": "karatsuba_fused" if complex_ else "int8_mod_gemm",
               "fp8": "fp8_karatsuba" if complex_ else "fp8_mod_gemm"}[execution]
    return {"residue_cast": 2, product: 1, "crt_garner": 1}


def tuning(results, GemmPolicy, linalg, kernels):
    """Phase 5: the tune entry point in full mode, then phase 3's 4096^3
    GEMMs under the calibration it wrote.  Returns the tune run's launch
    counts."""
    from repro_torch.core import perfmodel
    from repro_torch.tune import __main__ as tune_cli
    from repro_torch.tune.cache import load_calibration

    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "calibration.json")
        kernels.reset_launches()
        t0 = time.perf_counter()
        tune_cli.main(["--out", path, "-v"])
        tune_s = time.perf_counter() - t0
        tune_counts = kernels.launch_counts()
        print(f"  python -m repro_torch.tune (full) ran {tune_s:.2f} s; launches {tune_counts}", flush=True)
        if tune_counts["launch_copy"] != 4:
            raise AssertionError(f"the calibration launched the copy kernel {tune_counts['launch_copy']} "
                                 "times, expected 1 warm-up + 3")
        cal = load_calibration(path)
        if cal is None:
            raise AssertionError("the calibration the tune entry point wrote does not load")
        preset = perfmodel.GH200
        for field in ("mem_bw", "int8_ops", "fp8_ops", "native_c64", "native_c128", "gemm_launch_s"):
            print(f"  hw {field}: measured={getattr(cal.hw, field):.6e} "
                  f"GH200 preset={getattr(preset, field):.6e}", flush=True)
        for key, tile in cal.blocks:
            print(f"  tuned {key}: {tile_label(tile)}", flush=True)

        for execution in ("kernel", "fused", "fp8"):
            pol = GemmPolicy(execution=execution, mode="fast", calibration=path)
            kernels.reset_launches()
            for r in results:
                routine, size, a, b = r["routine"], r["size"], r["a"], r["b"]
                fn = getattr(linalg, routine)
                before = kernels.launch_counts()
                first = fn(a, b, policy=pol)
                y, ms = timed_calls(lambda: fn(a, b, policy=pol), 3)
                what = f"calibrated {execution} {routine} {size}^3"
                check_launches(kernels, before, path_expect(execution, a.is_complex()), 4, what,
                               model_launches(execution, default_moduli(a), a.is_complex()))
                if not (same_bits(first, r["y"]) and same_bits(y, r["y"])):
                    raise AssertionError(f"{what}: differs from the uncalibrated output")
                base_ms = r["kernel_ms" if execution == "kernel" else f"{execution}_ms"]
                print(f"  {routine} {size}^3 fast {execution} calibrated: emulated_ms={ms:.3f} "
                      f"uncalibrated_ms={base_ms:.3f} launches/GEMM="
                      f"{sum(path_expect(execution, a.is_complex()).values())} "
                      f"== uncalibrated, bitwise", flush=True)

        for label, calibration in (("GH200 preset", None), ("calibrated", path)):
            for execution in ("kernel", "fused", "fp8"):
                base = dict(backend="ozaki2_c128", execution=execution, calibration=calibration)
                auto = GemmPolicy(formulation="auto", **base).plan_for(MAIN, MAIN, MAIN)
                adaptive = GemmPolicy(mode="auto", rtol=1e-6, **base).plan_for(MAIN, MAIN, MAIN)
                print(f"  zgemm {MAIN}^3 {execution} under the {label}: formulation='auto' -> "
                      f"{auto.formulation}; rtol=1e-6 mode='auto' -> mode={adaptive.mode} "
                      f"n_moduli={adaptive.n_moduli}", flush=True)
            hw = cal.hw if calibration else preset
            print(f"  select_engine zgemm {MAIN}^3 N=14 under the {label}: "
                  f"{perfmodel.select_engine(MAIN, MAIN, MAIN, 14, hw=hw)}", flush=True)
    return tune_counts


def attention_prefill(full, kernels):
    """Phase 6: the attention entry point on phase 2's full-width bf16
    inputs, 1 + 3 calls, one launch each.  Returns the launch counts."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, checked = full
    kernels.reset_launches()
    first = fa.flash_attention(q, k, v)
    y, ms = timed_calls(lambda: fa.flash_attention(q, k, v), 3)
    counts = kernels.launch_counts()
    want = {name: 4 if name == "flash_attention" else 0 for name in counts}
    if counts != want:
        raise AssertionError(f"attention prefill: launches {counts}, expected {want}")
    if not (same_bits(first, checked) and same_bits(y, checked)):
        raise AssertionError("attention prefill: differs from the output phase 2 held against the plain version")
    b, s, h, _ = q.shape
    _, flop = attention_work(q, k, True)
    print(f"  flash_attention prefill B={b} S={s} H={h} KV={k.shape[2]} D={q.shape[3]} bf16 causal: "
          f"ms/call={ms:.3f} ({flop / ms / 1e9:.1f} TFLOP/s over {flop:.4e} flop) launches/call=1 "
          f"== phase 2's checked output, bitwise", flush=True)
    return counts


SERVE_REDUCED_B, SERVE_REDUCED_S, SERVE_REDUCED_NEW = 2, 32, 4  # phase 7a
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 128, 16  # phase 7b: starcoder2-3b as published
SERVE_RESTORE_LAYERS = 2  # phase 7b's prepared_dir round trip at full width
# phase 7a: card against cpu, float32.  The emulated products are bitwise
# given equal inputs; the native layers (cuBLAS against the CPU's float32
# products, exp, rsqrt) differ in the last ulps, held as the CPU tests hold
# the port against the reference: logits within 1e-4 x max|logits|, tokens
# equal where the cpu's top-2 margin exceeds twice that.
SERVE_CARD_TOL = 1e-4
# but recurrentgemma-2b: its RG-LRU computes sqrt(1 - exp(2 log a)) in
# float32 (the reference's formulation), which cancels where a is near 1,
# and at the random init many gates saturate there (log a = 0 exactly in
# the reduced model).  One float32 rounding inside that difference moves
# the reduced model's logits by up to 6.7e-4 x max|logits| (that exp in
# float64 instead, on the CPU), and the card's expf and the CPU's differ
# in the last ulp: held within 2e-3 there.
SERVE_CARD_TOL_OF = {"recurrentgemma-2b": 2e-3}
# phase 7b: emulated against a model with float64 linears, at full width.
# At its random init starcoder2-3b amplifies a product's rounding through
# its 30 layers (its stacked weights draw with std 1/sqrt(30), the
# reference's fan-in rule reading the layer axis, so the residual stream
# grows to ~4,500): float32 cuBLAS linears leave the last position's hidden
# state 1e-5 of its max from float64 ones after layer 1 and the logits 0.27
# of their max after layer 30 (tools/serve_profile.py).  So the end-to-end
# bound is held where it still bites, on the same widths with
# SERVE_RESTORE_LAYERS layers: the emulated engine's logits (the prefill's
# and every decode step's) within SERVE_WIDE_TOL x max|logits| of the
# float64 linears' model, the float32 rule of the CPU tests, and its tokens
# equal wherever that model's top-2 margin exceeds twice that.  At 30
# layers every linear of layer 0 is held bitwise to device="cpu" at the
# serving shapes instead.
SERVE_WIDE_TOL = 1e-4
# phase 8 holds recurrentgemma-2b to 2e-3 for the reason of
# SERVE_CARD_TOL_OF: emulated and float64 linears hand its float32 RG-LRU
# gates inputs a rounding apart, and sqrt(1 - exp(2 log a)) cancels near
# a = 1 (native float32 linears are as far from float64 ones; printed)
SERVE_WIDE_TOL_OF = {"recurrentgemma-2b": 2e-3}
# the MoE archs route by a native float32 product: two runs that agree to
# rounding may route a token whose k-th and (k+1)-th router logits nearly
# tie to other experts, and that token then moves by O(1).  A flip must lie
# within this relative gap of a tie (`routing.RouteLog`: the gap over |x|
# times the larger router column's norm, the most a relative change of x
# can move either logit; the runs compared here agree to ~1e-6), and the
# tokens it excludes are counted and held under 1 % (`route_flip`).
ROUTE_MARGIN = 1e-4


def top2_margin(logits):
    """Per row, the largest logit minus the second largest."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def route_flip(what, routes, row, step):
    """The MoE rule of phases 7a and 8 at one (row, step) of two generates:
    None if both runs routed that step's tokens of `row` to the same
    experts in every layer, else the first flipped position in the row.
    Such a flip is legitimate only near a tie: every token of the first
    layer that flipped must lie within ROUTE_MARGIN of one in either run
    (a flip in a later layer may follow from it).  A flip in a group that
    dropped a token at capacity moves the other rows' slots: it fails the
    comparison.  routes = (got, want, MoE layers, prompt length), each run's
    `RouteLog.routes` of a whole generate."""
    from repro_torch.models.routing import differing

    got, want, layers, prompt = routes
    n = prompt if step == 0 else 1
    first = step * layers
    for c in range(first, first + layers):
        flip = differing(got[c: c + 1], want[c: c + 1])[0][row * n: (row + 1) * n]
        if not bool(flip.any()):
            continue
        gap = torch.minimum(got[c].rel_gap, want[c].rel_gap)[row * n: (row + 1) * n]
        if bool((gap[flip] >= ROUTE_MARGIN).any()):
            raise AssertionError(f"{what}: row {row} step {step}: routed to other experts at a relative gap "
                                 f"{float(gap[flip].max()):.3e} >= {ROUTE_MARGIN} from a tie")
        if got[c].dropped or want[c].dropped:
            raise AssertionError(f"{what}: row {row} step {step}: a routing flip near a tie in a group that "
                                 f"dropped tokens at capacity (it moves every later token's slot)")
        return int(flip.nonzero()[0, 0])
    return None


def check_tokens_and_logits(what, got_tok, got_logits, want_tok, want_logits, tol, routes=None):
    """`generate`'s tokens (B, n) and logits (B, n + 1, vocab) against
    `want`'s, step by step and row by row while the contexts agree: logits
    within tol x max|logits|, and the token equal wherever want's top-2
    margin exceeds 2 tol x max|logits|.  For an MoE model, `routes` (see
    `route_flip`): a row whose tokens the two runs routed to other experts
    near a tie is compared up to that step and excluded from there on (its
    later tokens counted as excluded), and no more than 1 % of the routed
    tokens may be excluded.  Returns (compared tokens, the largest
    relative difference of the logits, excluded tokens)."""
    got_tok, want_tok = got_tok.cpu(), want_tok.cpu()
    got_logits, want_logits = got_logits.cpu().double(), want_logits.cpu().double()
    compared, worst, excluded = 0, 0.0, 0
    rows, steps = want_tok.shape[0], want_logits.shape[1]
    for row in range(rows):
        for i in range(steps):
            if routes is not None:
                pos = route_flip(what, routes, row, i)
                if pos is not None:
                    excluded += (routes[3] - pos + steps - 1) if i == 0 else steps - i
                    break
            w = want_logits[row, i]
            scale = float(w.abs().max())
            rel = float((got_logits[row, i] - w).abs().max()) / scale
            worst = max(worst, rel)
            if not rel <= tol:
                raise AssertionError(f"{what}: row {row} step {i}: logits differ by {rel:.3e} x max|logits| > {tol}")
            if i == want_tok.shape[1]:
                break
            if float(top2_margin(w)) > 2 * tol * scale:
                if int(got_tok[row, i]) != int(want_tok[row, i]):
                    raise AssertionError(f"{what}: row {row} step {i}: token {int(got_tok[row, i])} "
                                         f"against {int(want_tok[row, i])} at a margin over {2 * tol} x max|logits|")
                compared += 1
            if int(got_tok[row, i]) != int(want_tok[row, i]):
                break  # the contexts differ from here on
    if routes is not None:
        routed = rows * (routes[3] + steps - 1)
        if excluded > 0.01 * routed:
            raise AssertionError(f"{what}: routing flips near ties exclude {excluded} of {routed} routed tokens, "
                                 f"over 1 %")
    return compared, worst, excluded


def moe_routes(cfg, log, prompt):
    """The `routes` argument of `check_tokens_and_logits` for a pair of
    generates' logs (None for a model with no MoE layer)."""
    layers = sum(cnt for _, mk, cnt in cfg.layer_groups if mk == "moe")
    return (log[0].routes, log[1].routes, layers, prompt) if layers else None


def model_serving_reduced(rng, dev, GemmPolicy):
    """Phase 7a: every arch, reduced, float32, from the port's init
    (torch.Generator seed 0, drawn on the CPU and moved): layer 0's
    emulated linears of each layer group on `kernel`, card == cpu bitwise;
    prefill + SERVE_REDUCED_NEW greedy steps on `kernel`, card against cpu
    within SERVE_CARD_TOL, the MoE archs under the routing rule."""
    from repro_torch.configs import ARCHS, get_reduced
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import Model
    from repro_torch.models.layers import apply_linear
    from repro_torch.models.routing import RouteLog
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import to_device

    pol = GemmPolicy(backend="ozaki2_f32", execution="kernel")
    for arch in ARCHS:
        cfg = get_reduced(arch, dtype="float32", gemm_policy=pol)
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        linears = model_linears(params, cfg)
        for name, p in linears.items():
            k = p["w"].shape[0]
            x = torch.from_numpy(phi_matrix(rng, (SERVE_REDUCED_B, SERVE_REDUCED_S, k), PHI, np.float32))
            on_card = apply_linear(to_device(p, dev), x.to(dev), pol)
            on_cpu = apply_linear(p, x, pol)
            if on_card.device.type != dev.type or not same_bits(on_card.cpu(), on_cpu):
                raise AssertionError(f"{arch} {name}: the card differs from device='cpu': "
                                     f"{first_difference(on_card.cpu(), on_cpu)}")
        batch = prompt_batch(cfg, SERVE_REDUCED_B, SERVE_REDUCED_S, rng, torch.device("cpu"))
        npre = cfg.n_prefix_embeds if cfg.frontend else 0
        cache_len = SERVE_REDUCED_S + npre + SERVE_REDUCED_NEW
        card = ServeEngine(model, params, cache_len, SERVE_REDUCED_B)
        cpu = ServeEngine(model, params, cache_len, SERVE_REDUCED_B, device="cpu")
        logs = (RouteLog(), RouteLog())
        with logs[0]:
            tok, logits = card.generate(batch, SERVE_REDUCED_NEW, return_logits=True)
        if tok.device.type != dev.type:
            raise AssertionError(f"{arch}: the engine did not serve on the card")
        with logs[1]:
            want_tok, want_logits = cpu.generate(batch, SERVE_REDUCED_NEW, return_logits=True)
        routes = moe_routes(cfg, logs, SERVE_REDUCED_S)
        tol = SERVE_CARD_TOL_OF.get(arch, SERVE_CARD_TOL)
        compared, worst, excluded = check_tokens_and_logits(f"{arch} card vs cpu", tok, logits, want_tok,
                                                            want_logits, tol, routes)
        rule = "" if routes is None else f", {excluded} routed tokens excluded by the routing rule"
        print(f"  {arch} reduced f32 kernel: {len(linears)} linears ({', '.join(linears)}) card == cpu, bitwise; "
              f"prefill + {SERVE_REDUCED_NEW} decode steps: logits within {worst:.2e} x max|logits| of cpu "
              f"(bound {tol}), "
              f"{compared} tokens compared, equal{rule}", flush=True)


def layer_linears(group, i):
    """{name: {"w", "b"}} of every linear of layer i of a stacked group:
    each dict with a "w" (an MoE layer's router and stacked experts are
    native products, not linears)."""
    from repro_torch.models.transformer import layer_params

    def walk(tree, prefix):
        if "w" in tree:
            return {prefix: tree}
        return {name: p for k, v in tree.items() if isinstance(v, dict)
                for name, p in walk(v, f"{prefix}.{k}" if prefix else k).items()}

    lp = layer_params(group, i)
    return walk({k: lp[k] for k in ("block", "mlp") if k in lp}, "")


def model_linears(params, cfg):
    """The linears of every kind of layer a model has: layer 0's of the
    first group of each (block, MLP) kind, by group index."""
    first = {}
    for g, (bk, mk, _) in enumerate(cfg.layer_groups):
        first.setdefault((bk, mk), g)
    return {f"{g}.{name}": p for g in first.values() for name, p in layer_linears(params["groups"][g], 0).items()}


def float64_linears(params):
    """The model with float64 linears: every linear bundle's "w" and "b"
    and the embedding (and head) in float64, every other leaf (norms, the
    conv, the recurrences' parameters, the router and the experts, native
    products in both models) as it is, so that the two models differ in
    their emulated linears alone."""
    def walk(tree):
        if isinstance(tree, dict):
            if "w" in tree:
                return {k: v.double() for k, v in tree.items()}
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return dict(walk(params), **{k: params[k].double() for k in ("embed", "head") if k in params})


def serve_run(eng, batch, kernels):
    """One engine: a warm-up, then the whole generate with the launch
    counters zeroed just before and read just after, and the prefill's end
    marked inside that same generate (a synchronize after `model.prefill`).
    Returns (tokens, logits, launches, prefill ms, decode ms a token,
    generate ms)."""
    eng.generate(batch, 1)
    model, marks = eng.model, []
    prefill = model.prefill

    def marked(*args, **kwargs):
        out = prefill(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return out

    model.prefill = marked
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, logits = eng.generate(batch, SERVE_NEW, return_logits=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        del model.prefill
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    counts["int8_mod_gemm:tma"] = kernels.int8_mod_gemm.int8_mod_gemm_batched.tma_launches
    return (tok, logits, counts, (marks[0] - t0) * 1e3, (t1 - marks[0]) * 1e3 / SERVE_NEW,
            (t1 - t0) * 1e3)


def full_width_linears(rng, dev, linears, policies, kernels, what="layer 0's"):
    """`linears` (a full-width model's, by name) at the serving shapes,
    decode (B, 1, k) and prefill (B, prompt, k), through `apply_linear` on
    the card under each policy, unprepared and prepared on the card, each
    bitwise equal to device="cpu" (the kernels' plain versions on the
    `kernel` execution, the weight prepared once on the CPU: the CPU tests
    hold prepared == unprepared and fused == kernel there).  Prints each
    linear's int8_mod_gemm launches and how many took its TMA path."""
    from repro_torch.core.policy import prepare_weights
    from repro_torch.models.layers import apply_linear
    from repro_torch.serve.engine import to_device

    t0 = time.perf_counter()
    kernels.reset_launches()
    product = kernels.int8_mod_gemm.int8_mod_gemm_batched
    paths = {}
    for name, p in linears.items():
        k, n = p["w"].shape
        on_cpu = prepare_weights(to_device(p, torch.device("cpu")), policies[0], device="cpu")
        card = {(pol.execution, prepared): prepare_weights(p, pol) if prepared else p
                for pol in policies for prepared in (False, True)}
        before, tma_before = product.launches, product.tma_launches
        for s in (1, SERVE_PROMPT):
            x = torch.from_numpy(phi_matrix(rng, (SERVE_B, s, k), PHI, np.float32))
            want = apply_linear(on_cpu, x, policies[0])
            for pol in policies:
                for prepared in (False, True):
                    got = apply_linear(card[pol.execution, prepared], x.to(dev), pol)
                    if got.device.type != dev.type or not same_bits(got.cpu(), want):
                        raise AssertionError(
                            f"{what} {name} ({k}x{n}) at ({SERVE_B}, {s}, {k}), {pol.execution} "
                            f"{'prepared' if prepared else 'unprepared'}: the card differs from device='cpu': "
                            f"{first_difference(got.cpu(), want)}")
        paths[f"{name} {k}x{n}"] = (product.launches - before, product.tma_launches - tma_before)
        del card
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    print(f"  {what} {len(linears)} linears ({', '.join(linears)}) at ({SERVE_B}, 1, k) and "
          f"({SERVE_B}, {SERVE_PROMPT}, k) on {' and '.join(p.execution for p in policies)}, unprepared and "
          f"prepared: card == cpu, bitwise, in {time.perf_counter() - t0:.1f} s (launches {counts}; "
          f"int8_mod_gemm launches by TMA of each: "
          f"{', '.join(f'{n} {t}/{a}' for n, (a, t) in paths.items())}; not counted as the main path's)",
          flush=True)


def model_serving_full(rng, dev, GemmPolicy, kernels):
    """Phase 7b: starcoder2-3b as published (30 layers, float32), served by
    four engines, its linears held to the CPU at full width, and with
    SERVE_RESTORE_LAYERS layers the prepared_dir round trip and the bound
    against float64 linears.  Returns the launches of the engines' runs by
    kernel."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core.policy import NATIVE
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_map

    cfg = get_config("starcoder2-3b", dtype="float32")
    emu = GemmPolicy(backend="ozaki2_f32", execution="kernel")
    fused = GemmPolicy(backend="ozaki2_f32", execution="fused")
    n_lin = 6 * cfg.n_layers  # q, k, v, o, up, down a layer
    calls = 1 + SERVE_NEW  # the prefill and every decode step
    model_of = lambda pol, c=cfg: Model(dataclasses.replace(c, gemm_policy=pol))  # noqa: E731
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    params_gb = torch.cuda.memory_allocated() / 2**30
    print(f"  starcoder2-3b: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_count() / 1e9:.3f} B params, float32, init on the card in "
          f"{time.perf_counter() - t0:.2f} s ({params_gb:.2f} GiB allocated, shared by every engine)", flush=True)
    full_width_linears(rng, dev, layer_linears(params["groups"][0], 0), (emu, fused), kernels)
    batch = prompt_batch(cfg, SERVE_B, SERVE_PROMPT, rng, dev)
    cache_len = SERVE_PROMPT + SERVE_NEW
    per_gemm = {"kernel": {"residue_cast": 2, "int8_mod_gemm": 1, "crt_garner": 1},
                "prepared": {"residue_cast": 1, "int8_mod_gemm": 1, "crt_garner": 1},
                "fused": {"fused_mod_gemm": 1}}
    model_count = {"kernel": model_launches("kernel", 8, False),
                   "prepared": model_launches("kernel", 8, False, prepared=True),
                   "fused": model_launches("fused", 8, False, prepared=True)}
    phase, runs, peaks = {}, {}, []

    def build(pol, prepare, prepared_dir=None, c=cfg, p=params):
        """An engine, timed, with the peak memory counter reset just before
        it is constructed (the previous engine already dropped)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng = ServeEngine(model_of(pol, c), p, cache_len, SERVE_B, prepare=prepare, prepared_dir=prepared_dir)
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t

    def run(name, pol, prepare, expect):
        eng, prep_s = build(pol, prepare)
        tok, logits, counts, prefill_ms, decode_ms, total_ms = serve_run(eng, batch, kernels)
        tma = counts.pop("int8_mod_gemm:tma")
        for k, v in counts.items():
            phase[k] = phase.get(k, 0) + v
        if expect is None and counts:
            raise AssertionError(f"{name}: launched {counts}")
        if expect is not None:
            want = {k: v * n_lin * calls for k, v in per_gemm[expect].items()}
            if counts != want or sum(counts.values()) != model_count[expect] * n_lin * calls:
                raise AssertionError(f"{name}: launches {counts}, expected {want} "
                                     f"({model_count[expect]} a linear, perfmodel.kernel_launch_count)")
        runs[name] = (tok, logits)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        print(f"  {name}: prepare_s={prep_s:.3f} prefill_ms={prefill_ms:.3f} decode_ms/token={decode_ms:.3f} "
              f"tokens/s={SERVE_B * SERVE_NEW / total_ms * 1e3:.1f} (B={SERVE_B}, {SERVE_PROMPT}-token prompts, "
              f"{SERVE_NEW} new; prefill and decode from one generate) peak_GB={peaks[-1]:.2f} (this engine's "
              f"construction and run, the shared params included) launches={counts} "
              f"({sum(counts.values()) // calls} a forward call; int8 by TMA {tma})", flush=True)

    run("native", NATIVE, False, None)
    run("kernel unprepared", emu, False, "kernel")
    run("kernel prepared", emu, True, "prepared")
    run("fused prepared", fused, True, "fused")
    ref_tok, ref_logits = runs["kernel unprepared"]
    for name in ("kernel prepared", "fused prepared"):
        tok, logits = runs[name]
        if not (torch.equal(tok, ref_tok) and same_bits(logits, ref_logits)):
            raise AssertionError(f"{name} differs from the unprepared kernel engine: "
                                 f"{first_difference(logits, ref_logits)}")
    print(f"  kernel prepared == kernel unprepared == fused prepared: tokens and the logits of the prefill "
          f"and all {SERVE_NEW} decode steps, bitwise", flush=True)
    nat_tok, nat_logits = runs["native"]
    emu_nat = float((ref_logits[:, 0] - nat_logits[:, 0]).abs().max() / nat_logits[:, 0].abs().max())
    print(f"  {cfg.n_layers} layers, emulated against native (not held: the random-init model amplifies rounding): prefill "
          f"logits {emu_nat:.3e} x max|logits| apart, greedy tokens equal in {int((ref_tok == nat_tok).sum())} "
          f"of {ref_tok.numel()}", flush=True)

    # at full width with fewer layers: the prepared_dir round trip, and the
    # emulated engine held to the model with float64 linears
    small = dataclasses.replace(cfg, n_layers=SERVE_RESTORE_LAYERS)
    sparams = {"embed": params["embed"], "head": params["head"], "final_norm": params["final_norm"],
               "groups": [{k: _take_layers(v, SERVE_RESTORE_LAYERS) for k, v in params["groups"][0].items()}]}
    pdir = tempfile.mkdtemp(prefix="prepared-", dir=tempfile.gettempdir())
    try:
        small_runs = {}
        for name, prepare, pd in (("unprepared", False, None), ("prepared, saved", True, pdir),
                                  ("restored", True, pdir)):
            kernels.reset_launches()
            eng, s = build(emu, prepare, pd, small, sparams)
            casts = kernels.launch_counts()["residue_cast"]
            small_runs[name] = eng.generate(batch, SERVE_NEW, return_logits=True)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            print(f"  {SERVE_RESTORE_LAYERS} layers {name}: construction {s:.3f} s, {casts} casts", flush=True)
            if name == "restored" and casts:
                raise AssertionError(f"prepared_dir: the second construction cast {casts} weights")
            if name == "prepared, saved" and casts != 6 * SERVE_RESTORE_LAYERS:
                raise AssertionError(f"prepared_dir: the first construction cast {casts} weights")
            del eng
        planes_gb = sum(f.stat().st_size for f in pathlib.Path(pdir).rglob("*")) / 1e9
        base_tok, base_logits = small_runs["unprepared"]
        for name in ("prepared, saved", "restored"):
            tok, logits = small_runs[name]
            if not (torch.equal(tok, base_tok) and same_bits(logits, base_logits)):
                raise AssertionError(f"prepared_dir {name} differs from unprepared")
        print(f"  prepared_dir: {planes_gb:.2f} GB of planes saved; the restore cast nothing and serves "
              f"== prepared == unprepared, bitwise", flush=True)
    finally:
        shutil.rmtree(pdir, ignore_errors=True)
    nat_small = ServeEngine(model_of(NATIVE, small), sparams, cache_len, SERVE_B).generate(
        batch, SERVE_NEW, return_logits=True)
    p64 = tree_map(lambda t: t.double(), sparams)
    wide_tok, wide_logits = ServeEngine(model_of(NATIVE, small), p64, cache_len, SERVE_B).generate(
        batch, SERVE_NEW, return_logits=True)
    del p64
    compared, worst, _ = check_tokens_and_logits(f"{SERVE_RESTORE_LAYERS} layers, emulated against float64 linears",
                                              base_tok, base_logits, wide_tok, wide_logits, SERVE_WIDE_TOL)
    prefill_dist = lambda logits: float(((logits[:, 0].double() - wide_logits[:, 0].double()).abs().amax(-1)  # noqa: E731
                                         / wide_logits[:, 0].double().abs().amax(-1)).max())
    print(f"  {SERVE_RESTORE_LAYERS} layers at full width against the model with float64 linears, prefill + "
          f"{SERVE_NEW} decode steps: emulated logits within {worst:.3e} x max|logits| (bound {SERVE_WIDE_TOL}), "
          f"{compared} tokens compared, equal; the prefill's logits: emulated {prefill_dist(base_logits):.3e}, native "
          f"float32 {prefill_dist(nat_small[1]):.3e}", flush=True)
    print(f"  phase 7b peak memory {max(peaks):.2f} GiB (the largest engine's)", flush=True)
    return phase


# phase 8: the SSD, RG-LRU and MoE archs as published, float32, B = 4,
# 128-token prompts, 16 greedy new tokens; arch: (depth on the card, why
# cut, emulated linears a forward call, layers of the float64 check).
# deepseek-moe-16b's 28 layers are 65.5 GB of float32 params, too much
# beside the prepared planes on one 80 GB card: 4 layers (the dense layer
# 0 and three MoE layers) at full width.  The float64 check runs 2 layers
# (3 for recurrentgemma-2b, so that one period includes its attention).
BLOCK_ARCHS = {
    "mamba2-130m": (None, None, 48, 2),
    "recurrentgemma-2b": (None, None, 200, 3),
    "granite-moe-3b-a800m": (None, None, 128, 2),
    "deepseek-moe-16b": (4, "28 layers of float32 params (65.5 GB) do not fit beside the prepared planes "
                            "on one 80 GB card", 28, 2),
}


def count_linears(params):
    """Emulated linears a forward call runs: each group's linear bundles
    times its layers."""
    from repro_torch.models.transformer import _n_layers

    return sum(len(layer_linears(group, 0)) * _n_layers(group) for group in params["groups"])


def prefix_params(params, cfg, small):
    """`params` of `cfg` cut to `small`'s layers (`small.layer_groups` is a
    prefix of `cfg`'s, its last group possibly shorter)."""
    groups = []
    for (bk, mk, cnt), (fbk, fmk, _), group in zip(small.layer_groups, cfg.layer_groups, params["groups"]):
        if (bk, mk) != (fbk, fmk):
            raise AssertionError(f"{small.name}: layer groups {small.layer_groups} are no prefix of {cfg.layer_groups}")
        groups.append(_take_layers(group, cnt))
    return dict(params, groups=groups)


def model_serving_blocks(rng, dev, GemmPolicy, kernels):
    """Phase 8: mamba2-130m, recurrentgemma-2b, granite-moe-3b-a800m and
    deepseek-moe-16b at full width (BLOCK_ARCHS), one at a time: layer 0's
    linears of each layer group held to device="cpu" at the serving shapes;
    served by a native and a prepared `kernel` engine (launches checked
    against `kernel_launch_count` x the linears a forward call); the
    emulated engine at 2 or 3 layers held to the model with float64
    linears.  Returns the prepared engines' launches by kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import NATIVE
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import Model
    from repro_torch.models.routing import RouteLog
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_leaves

    emu = GemmPolicy(backend="ozaki2_f32", execution="kernel")
    fused = GemmPolicy(backend="ozaki2_f32", execution="fused")
    per_gemm = {"residue_cast": 1, "int8_mod_gemm": 1, "crt_garner": 1}  # prepared
    a_linear = model_launches("kernel", 8, False, prepared=True)
    calls = 1 + SERVE_NEW
    cache_len = SERVE_PROMPT + SERVE_NEW
    phase = {}
    for arch, (depth, why, n_lin, check_layers) in BLOCK_ARCHS.items():
        t_arch = time.perf_counter()
        cfg = get_config(arch, dtype="float32", **({} if depth is None else {"n_layers": depth}))
        published = get_config(arch).n_layers
        model_of = lambda pol, c=cfg: Model(dataclasses.replace(c, gemm_policy=pol))  # noqa: E731
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = Model(cfg).init(torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        if count_linears(params) != n_lin:
            raise AssertionError(f"{arch}: {count_linears(params)} emulated linears a forward call, "
                                 f"expected {n_lin}")
        cut = "whole" if depth is None else f"cut to {depth} of {published} layers: {why}"
        print(f"  {arch}: {cfg.n_layers} layers ({cut}), d_model {cfg.d_model}, vocab {cfg.vocab}, "
              f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B params, float32, init on the card in "
              f"{time.perf_counter() - t0:.2f} s ({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated); "
              f"{n_lin} emulated linears a forward call", flush=True)
        # layer 0's, and recurrentgemma's first attention layer (layer 2,
        # group 1's layer 0; its MLP is layer 0's kind)
        linears = {k: v for k, v in model_linears(params, cfg).items()
                   if not (arch == "recurrentgemma-2b" and k.startswith("1.mlp"))}
        full_width_linears(rng, dev, linears, (emu, fused), kernels, what=f"{arch} layer 0's")
        del linears
        batch = prompt_batch(cfg, SERVE_B, SERVE_PROMPT, rng, dev)
        runs = {}
        for name, pol, prepare in (("native", NATIVE, False), ("kernel prepared", emu, True)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng = ServeEngine(model_of(pol), params, cache_len, SERVE_B, prepare=prepare)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t
            tok, logits, counts, prefill_ms, decode_ms, total_ms = serve_run(eng, batch, kernels)
            tma = counts.pop("int8_mod_gemm:tma")
            if pol is NATIVE:
                if counts:
                    raise AssertionError(f"{arch} {name}: launched {counts}")
            else:
                want = {k: v * n_lin * calls for k, v in per_gemm.items()}
                if counts != want or sum(counts.values()) != a_linear * n_lin * calls:
                    raise AssertionError(f"{arch} {name}: launches {counts}, expected {want} ({a_linear} a linear, "
                                         f"perfmodel.kernel_launch_count, x {n_lin} linears x {calls} calls)")
                for k, v in counts.items():
                    phase[k] = phase.get(k, 0) + v
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} {name}: non-finite logits")
            runs[name] = (tok, logits)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"  {arch} {name}: prepare_s={prep_s:.3f} prefill_ms={prefill_ms:.3f} "
                  f"decode_ms/token={decode_ms:.3f} tokens/s={SERVE_B * SERVE_NEW / total_ms * 1e3:.1f} "
                  f"(B={SERVE_B}, {SERVE_PROMPT}-token prompts, {SERVE_NEW} new) peak_GB={peak:.2f} "
                  f"launches={counts} ({sum(counts.values()) // calls} a forward call; int8 by TMA {tma})",
                  flush=True)
            del eng
        nat_tok, emu_tok = runs["native"][0], runs["kernel prepared"][0]
        print(f"  {arch} {cfg.n_layers} layers, emulated against native (not held: random-init models amplify "
              f"rounding): greedy tokens equal in {int((nat_tok == emu_tok).sum())} of {emu_tok.numel()}", flush=True)
        del runs

        # the emulated engine against the model with float64 linears, at
        # full width with check_layers layers
        small = dataclasses.replace(cfg, n_layers=check_layers)
        sparams = prefix_params(params, cfg, small)
        p64 = float64_linears(sparams)
        logs = (RouteLog(), RouteLog())
        with logs[0]:
            got_tok, got_logits = ServeEngine(model_of(emu, small), sparams, cache_len, SERVE_B).generate(
                batch, SERVE_NEW, return_logits=True)
        with logs[1]:
            wide_tok, wide_logits = ServeEngine(model_of(NATIVE, small), p64, cache_len, SERVE_B).generate(
                batch, SERVE_NEW, return_logits=True)
        nat_tok, nat_logits = ServeEngine(model_of(NATIVE, small), sparams, cache_len, SERVE_B).generate(
            batch, SERVE_NEW, return_logits=True)
        del p64, sparams
        routes = moe_routes(small, logs, SERVE_PROMPT)
        tol = SERVE_WIDE_TOL_OF.get(arch, SERVE_WIDE_TOL)
        compared, worst, excluded = check_tokens_and_logits(
            f"{arch} {check_layers} layers, emulated against float64 linears", got_tok, got_logits, wide_tok,
            wide_logits, tol, routes)
        _, native_worst, _ = check_tokens_and_logits(f"{arch} native", nat_tok, nat_logits, wide_tok, wide_logits,
                                                     float("inf"))
        rule = "" if routes is None else (f"; routing rule: {excluded} of {SERVE_B * (SERVE_PROMPT + SERVE_NEW)} "
                                          f"routed tokens excluded")
        print(f"  {arch} {check_layers} layers at full width against the model with float64 linears, prefill + "
              f"{SERVE_NEW} decode steps: emulated logits within {worst:.3e} x max|logits| (bound {tol}; native "
              f"float32 linears {native_worst:.3e}, not held), {compared} tokens compared, equal{rule}", flush=True)
        del params, batch
        print(f"  {arch} took {time.perf_counter() - t_arch:.1f} s", flush=True)
    return phase


def _take_layers(tree, n):
    if isinstance(tree, dict):
        return {k: _take_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def serve_cli():
    """Phase 7c: the serve CLI once, on the card."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    rc = serve.main(["--arch", "starcoder2-3b", "--backend", "ozaki2_f32", "--execution", "kernel", "--prepare"])
    if rc != 0:
        raise AssertionError(f"repro_torch.launch.serve exited {rc}")
    print(f"  python -m repro_torch.launch.serve --arch starcoder2-3b --backend ozaki2_f32 --execution kernel "
          f"--prepare: exit 0 in {time.perf_counter() - t0:.2f} s", flush=True)


# phase 9: training.  The train CLI's AdamW (lr 3e-3, grad clip 5.0).
TRAIN_OPT = {"lr": 3e-3, "grad_clip": 5.0}
TRAIN_REDUCED_B, TRAIN_REDUCED_S = 2, 32  # 9a: one SyntheticLM batch, seed 0
# 9a: card against cpu, one step from the same weights.  The loss within
# TRAIN_LOSS_TOL relative (recurrentgemma-2b 2e-3: its float32 RG-LRU gates
# cancel near a = 1, SERVE_CARD_TOL_OF), and each grad leaf (read from the
# first moment after the step, `step_grads`) within TRAIN_GRAD_TOL x its
# max|g|: the native float32 layers round otherwise on the card (its expf,
# rsqrtf, reductions and cuBLAS sums) and the backward carries that.
TRAIN_LOSS_TOL = 1e-4
TRAIN_LOSS_TOL_OF = {"recurrentgemma-2b": 2e-3}
TRAIN_GRAD_TOL = 1e-3
# recurrentgemma-2b's grads within 1e-2: where its random-init RG-LRU gates
# saturate, 1 - a^2 lies near float32's rounding and the derivative of
# sqrt(max(1 - a^2, 1e-12)) amplifies the card's last-ulp differences
# (measured 3.3e-3 on the H100; on the CPU the port against the reference
# reads 3.5e-3 on tests/test_torch_train_archs.py's fixed draw, and the
# reference's jitted step against its own op-by-op step 1.8e-3)
TRAIN_GRAD_TOL_OF = {"recurrentgemma-2b": 1e-2}
TRAIN_COMPLEX_RTOL = 1e-3  # the reference's test_model_with_complex_policy_trains
TRAIN_EXECUTIONS = ("kernel", "fused", "fp8", "per_modulus_kernel")  # 9a's deterministic grads
# 9b: mamba2-130m as published, the train CLI's default batch and sequence
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_RESUME_AT = "mamba2-130m", 8, 256, 6, 2, 3
TRAIN_LINEARS = 48  # in_proj and out_proj of 24 SSD layers
TRAIN_ENGINE_RTOL = 1e-3  # 9b, 9c: step-0 loss (and grad_norm) emulated against native
# 9c: starcoder2-3b at full width, cut to 2 of its 30 layers: the whole
# model's params, grads, moments and master copy (20 B a float32 param)
# would take ~61 GB before activations
TRAIN_WIDE_ARCH, TRAIN_WIDE_LAYERS, TRAIN_WIDE_B, TRAIN_WIDE_S, TRAIN_WIDE_STEPS = "starcoder2-3b", 2, 4, 256, 2
TRAIN_WIDE_LINEARS = 12  # q, k, v, o, up, down of 2 layers
CLI_STEPS = (10, 12)  # 9d: the CLI's ckpt_every is max(10, steps // 4), so the first run saves step 10
# the port's kernel functions, as a profiler names them
PORT_KERNEL_FUNCTIONS = ("residue_cast_kernel", "mod_gemm_kernel", "crt_garner_kernel", "karatsuba_kernel",
                         "launch_copy_kernel", "fa_f32_kernel", "fa_bf16_kernel")
GEMMS_A_LINEAR = 4  # a train step's emulated GEMMs a linear: forward, its recompute (remat), dX, dW
# 9c's linears: the CPU's plain versions of all three products of layer
# 0's six linears at (4, 256, k) take ~2 minutes on 8 host cores, so the
# CPU computes 8 of every 64 rows and columns of each output
# (`train_linears`; rows alone took 77 s on an H100 machine's host, each
# sub-product casting the whole weight)
TRAIN_SAMPLE, TRAIN_SAMPLE_BLOCK = 8, 64


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms(True)` for a block (the script
    sets CUBLAS_WORKSPACE_CONFIG before CUDA starts); an op without a
    deterministic version raises."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def add_counts(total, counts):
    for k, v in counts.items():
        if v:
            total[k] = total.get(k, 0) + v


def nonzero_counts(kernels):
    return {k: v for k, v in kernels.launch_counts().items() if v}


def train_expect(execution, n_mod=8):
    """The launches of one real fast-mode GEMM on `execution`, by kernel."""
    if execution == "per_modulus_kernel":
        return {"residue_cast": 2, "int8_mod_gemm": n_mod, "crt_garner": 1}
    return path_expect(execution, False)


def check_train_launches(counts, expect, linears, steps, what):
    """`counts` of `steps` train steps: `expect` a GEMM x GEMMS_A_LINEAR x
    `linears`, by kernel."""
    want = {k: v * GEMMS_A_LINEAR * linears * steps for k, v in expect.items()}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want} ({GEMMS_A_LINEAR} GEMMs a linear a "
                             f"step x {linears} linears x {steps} steps)")


def sampled_index(n):
    """TRAIN_SAMPLE of every TRAIN_SAMPLE_BLOCK indices of n, at an offset
    that steps by TRAIN_SAMPLE from block to block (0-7, 72-79, 144-151,
    ...): every block of a 64-row or 64-column tile is read, and across
    the blocks every offset within one."""
    idx = torch.arange(n)
    per = TRAIN_SAMPLE_BLOCK // TRAIN_SAMPLE
    return idx[(idx % TRAIN_SAMPLE_BLOCK) // TRAIN_SAMPLE == (idx // TRAIN_SAMPLE_BLOCK) % per]


def train_linears(rng, dev, linears, pol, b, s, what, sampled=False):
    """Each linear of `linears` at the train shape (b, s, k) through
    `apply_linear` under `pol`: the forward and both gradients (dX, dW,
    for a cotangent drawn like x) on the card bitwise equal to
    device="cpu".  With `sampled` the card computes every product whole
    and the CPU only the `sampled_index` rows and columns of each output,
    each by a product of those rows of its left operand and those
    columns of its right one.  The emulation scales each row of its left
    operand and each column of its right one over the contraction, which
    these sub-products keep whole, so each equals its part of the whole
    product bit for bit.  These launches compare the card with the plain
    versions: not counted as the main path's."""
    from repro_torch.models.layers import apply_linear

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    checked = 0
    for name, p in linears.items():
        k, n = p["w"].shape
        x = torch.from_numpy(phi_matrix(rng, (b, s, k), PHI, np.float32))
        g = torch.from_numpy(phi_matrix(rng, (b, s, n), PHI, np.float32))
        w = p["w"].detach().to(cpu)
        outs = []
        for d in (dev, cpu):
            xd = x.to(d).detach().requires_grad_(True)
            wd = w.to(d).detach().requires_grad_(True)
            y = apply_linear({"w": wd}, xd, pol)
            dx, dw = torch.autograd.grad(y, (xd, wd), g.to(d))
            if not all(t.device == xd.device for t in (y, dx, dw)):
                raise AssertionError(f"{what} {name}: computed off {d}")
            outs.append([t.detach().cpu() for t in (y, dx, dw)])
            if sampled:
                break
        if sampled:
            tok, kk, nn = sampled_index(b * s), sampled_index(k), sampled_index(n)
            x2, g2 = x.reshape(b * s, k), g.reshape(b * s, n)
            y, dx, dw = outs[0]
            outs[0] = [y.reshape(b * s, n)[tok][:, nn], dx.reshape(b * s, k)[tok][:, kk], dw[kk][:, nn]]
            ys = apply_linear({"w": w[:, nn]}, x2[tok], pol)  # x's sampled rows, w's sampled columns
            xk = x2[tok][:, kk].requires_grad_(True)  # dX = g w^T: g's sampled rows, w's sampled rows
            (dxs,) = torch.autograd.grad(apply_linear({"w": w[kk]}, xk, pol), xk, g2[tok])
            wk = w[kk][:, nn].requires_grad_(True)  # dW = x^T g: x's sampled columns, g's sampled columns
            (dws,) = torch.autograd.grad(apply_linear({"w": wk}, x2[:, kk], pol), wk, g2[:, nn])
            outs.append([ys, dxs, dws])
        for part, got, want in zip(("forward", "dX", "dW"), *outs):
            checked += got.numel()
            if not same_bits(got, want):
                raise AssertionError(f"{what} {name} ({k}x{n}) at ({b}, {s}, {k}), {part}: the card differs from "
                                     f"device='cpu': {first_difference(got, want)}")
    part = (f", the CPU computing {TRAIN_SAMPLE} of every {TRAIN_SAMPLE_BLOCK} rows and columns of each output"
            if sampled else "")
    print(f"  {what}: {len(linears)} linears ({', '.join(linears)}) at the train shape ({b}, {s}, k): forward, "
          f"dX and dW card == cpu, bitwise ({checked} values{part}), in {time.perf_counter() - t0:.1f} s",
          flush=True)


def forward_routes(routes, remat):
    """A train step's routes of its forward alone: with remat each layer's
    forward runs again in the backward and records its routes again."""
    if not remat:
        return routes
    half = len(routes) // 2
    if len(routes) != 2 * half:
        raise AssertionError(f"{len(routes)} routed groups under remat: not the forward's twice")
    return routes[:half]


def hold_routes(what, card_routes, cpu_routes):
    """A train step's routing on the card equal to the cpu's, token for
    token.  Phases 7a and 8 set aside a token that flips near a tie; a
    step's loss and grads sum over every token, so here any flip fails
    (naming its gap to a tie)."""
    from repro_torch.models.routing import differing

    for c, mask in enumerate(differing(card_routes, cpu_routes)):
        if bool(mask.any()):
            gap = torch.minimum(card_routes[c].rel_gap, cpu_routes[c].rel_gap)[mask]
            raise AssertionError(f"{what}: group {c}: {int(mask.sum())} tokens routed to other experts on the card "
                                 f"than on the cpu (relative gaps to a tie {float(gap.min()):.3e} to "
                                 f"{float(gap.max()):.3e}; phases 7a and 8 set aside those within {ROUTE_MARGIN})")


def step_grads(state, met, opt):
    """A train step's grads from its first moment after one step from
    zeros, m = (1 - b1) clip g, with the step's own clip: a tree like m."""
    from repro_torch.tree import tree_map

    clip = min(1.0, opt.grad_clip / max(float(met["grad_norm"]), 1e-9))
    return tree_map(lambda m: m.double() / ((1 - opt.b1) * clip), state["m"])


def hold_grads(what, got, want, tol):
    """Each grad leaf within tol x its max|g| (both trees of float64
    tensors); returns the worst ratio.  A failure names every leaf over
    the bound."""
    from repro_torch.tree import tree_leaves

    ratios = []
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.cpu(), b.cpu()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: non-finite grads in a leaf {tuple(a.shape)}")
        scale = float(b.abs().max())
        ratios.append((float((a - b).abs().max()) / scale if scale else 0.0, tuple(a.shape)))
    over = [f"{shape} {r:.2e}" for r, shape in ratios if not r <= tol]
    if over:
        raise AssertionError(f"{what}: grad leaves over {tol} x max|g|: {', '.join(over)} (all: "
                             f"{', '.join(f'{s} {r:.1e}' for r, s in ratios)})")
    return max(r for r, _ in ratios)


def training_reduced(rng, dev, GemmPolicy, kernels):
    """Phase 9a: every arch reduced, float32, `ozaki2_f32` on `kernel`:
    layer 0's linears at the train shape card == cpu bitwise; one
    `make_train_step` step on the card and on the CPU from the same weights
    (drawn on the CPU, moved) and the same `SyntheticLM` batch, the loss
    and grads held (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL; MoE tokens routed
    alike, `hold_routes`), the card's launches 16 a linear.  Then reduced
    starcoder2-3b (1 layer) under `ozaki2_c64` on `kernel` (layer 0's
    linears card == cpu bitwise, its loss within 1e-3 of native, grads
    finite) and, under deterministic algorithms, its grads on the
    four executions of TRAIN_EXECUTIONS, bitwise equal.  Returns the
    main-path launches by kernel."""
    import dataclasses

    from repro_torch.configs import ARCHS, get_reduced
    from repro_torch.core.policy import NATIVE
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.models.routing import RouteLog
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import tree_leaves, tree_map

    pol = GemmPolicy(backend="ozaki2_f32", execution="kernel")
    opt = AdamWConfig(**TRAIN_OPT)
    cpu = torch.device("cpu")
    phase = {}
    for arch in ARCHS:
        t0 = time.perf_counter()
        cfg = get_reduced(arch, dtype="float32", gemm_policy=pol)
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        train_linears(rng, dev, model_linears(params, cfg), pol, TRAIN_REDUCED_B, TRAIN_REDUCED_S,
                      f"{arch} reduced layer 0's")
        n_lin = count_linears(params)
        tokens = SyntheticLM(DataConfig(cfg.vocab, TRAIN_REDUCED_S, TRAIN_REDUCED_B, seed=0)).batch(0)["tokens"]
        step = make_train_step(model, opt)[0]
        runs = []
        for d in (dev, cpu):
            p = tree_map(lambda t, d=d: t.to(d, copy=True), params)  # the step updates it in place
            state = adamw_init(p, opt)
            log = RouteLog()
            kernels.reset_launches()
            with log:
                _, state, met = step(p, state, {"tokens": torch.from_numpy(tokens).to(d)})
            if d is dev:
                card_counts = nonzero_counts(kernels)
                check_train_launches(card_counts, train_expect("kernel"), n_lin, 1, f"{arch} reduced train step")
                add_counts(phase, card_counts)
                if met["loss"].device.type != dev.type:
                    raise AssertionError(f"{arch}: the step did not run on the card")
            runs.append((step_grads(state, met, opt), {k: float(v) for k, v in met.items()},
                         forward_routes(log.routes, cfg.remat)))
        (card_grads, card, card_routes), (cpu_grads, want, cpu_routes) = runs
        hold_routes(arch, card_routes, cpu_routes)
        tol = TRAIN_LOSS_TOL_OF.get(arch, TRAIN_LOSS_TOL)
        rel = abs(card["loss"] - want["loss"]) / abs(want["loss"])
        if not all(np.isfinite(v) for v in card.values()):
            raise AssertionError(f"{arch}: non-finite metrics {card}")
        if not rel <= tol:
            raise AssertionError(f"{arch}: loss {card['loss']!r} on the card, {want['loss']!r} on the cpu: "
                                 f"{rel:.3e} relative > {tol}")
        grad_tol = TRAIN_GRAD_TOL_OF.get(arch, TRAIN_GRAD_TOL)
        worst = hold_grads(arch, card_grads, cpu_grads, grad_tol)
        routed = "" if not cpu_routes else f", all {TRAIN_REDUCED_B * TRAIN_REDUCED_S} tokens routed alike"
        print(f"  {arch} reduced f32 kernel train step: loss {card['loss']:.6f} (cpu {want['loss']:.6f}, "
              f"{rel:.2e} relative, bound {tol}), grad_norm {card['grad_norm']:.6f} (cpu "
              f"{want['grad_norm']:.6f}), grads within {worst:.2e} x max|g| of the cpu's (bound "
              f"{grad_tol}){routed}; {sum(card_counts.values())} launches ({n_lin} linears x 16) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    # one complex-policy step: karatsuba_fused through the linears
    t0 = time.perf_counter()
    cpol = GemmPolicy(backend="ozaki2_c64", execution="kernel")
    cfg = get_reduced("starcoder2-3b", dtype="float32", n_layers=1, gemm_policy=cpol)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    train_linears(rng, dev, model_linears(params, cfg), cpol, TRAIN_REDUCED_B, TRAIN_REDUCED_S,
                  "starcoder2-3b reduced (1 layer) ozaki2_c64 layer 0's")
    tokens = torch.from_numpy(SyntheticLM(DataConfig(cfg.vocab, TRAIN_REDUCED_S, TRAIN_REDUCED_B)).batch(0)["tokens"])
    with torch.no_grad():
        native, _ = Model(dataclasses.replace(cfg, gemm_policy=NATIVE)).loss(params, {"tokens": tokens.to(dev)})
    state = adamw_init(params, opt)
    kernels.reset_launches()
    params, state, met = make_train_step(model, opt)[0](params, state, {"tokens": tokens.to(dev)})
    counts = nonzero_counts(kernels)
    n_lin = count_linears(params)
    check_train_launches(counts, path_expect("kernel", True), n_lin, 1, "starcoder2-3b ozaki2_c64 train step")
    add_counts(phase, counts)
    rel = abs(float(met["loss"]) - float(native)) / abs(float(native))
    if not rel <= TRAIN_COMPLEX_RTOL:
        raise AssertionError(f"ozaki2_c64: loss {float(met['loss'])!r} against native {float(native)!r}: "
                             f"{rel:.3e} relative > {TRAIN_COMPLEX_RTOL}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves((params, state))):
        raise AssertionError("ozaki2_c64: non-finite params or grads after the step")
    print(f"  starcoder2-3b reduced (1 layer) ozaki2_c64 kernel train step: loss {float(met['loss']):.6f} against "
          f"native {float(native):.6f} ({rel:.2e} relative, bound {TRAIN_COMPLEX_RTOL}), grads finite; launches "
          f"{counts} in {time.perf_counter() - t0:.1f} s", flush=True)

    # the four executions' grads, bitwise equal under deterministic algorithms
    t0 = time.perf_counter()
    cfg = get_reduced("starcoder2-3b", dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device=dev)
    n_lin = count_linears(params)
    batch = {"tokens": tokens.to(dev)}
    grads = {}
    with deterministic():
        for execution in TRAIN_EXECUTIONS:
            epol = GemmPolicy(backend="ozaki2_f32", execution=execution)
            kernels.reset_launches()
            loss, _, g = loss_and_grads(Model(dataclasses.replace(cfg, gemm_policy=epol)), params, batch)
            counts = nonzero_counts(kernels)
            check_train_launches(counts, train_expect(execution), n_lin, 1, f"starcoder2-3b reduced {execution} grads")
            add_counts(phase, counts)
            grads[execution] = (loss, tree_leaves(g), sum(counts.values()))
    first, (loss0, g0, _) = TRAIN_EXECUTIONS[0], grads[TRAIN_EXECUTIONS[0]]
    for execution, (loss, g, _) in grads.items():
        if not same_bits(loss, loss0) or not all(same_bits(a, b) for a, b in zip(g, g0)):
            bad = next(i for i, (a, b) in enumerate(zip(g, g0)) if not same_bits(a, b))
            raise AssertionError(f"starcoder2-3b reduced grads on {execution} differ from {first}'s: leaf {bad}: "
                                 f"{first_difference(g[bad].cpu(), g0[bad].cpu())}")
    print(f"  starcoder2-3b reduced grads under deterministic algorithms on {', '.join(TRAIN_EXECUTIONS)}: bitwise "
          f"equal ({len(g0)} leaves; launches {', '.join(f'{e} {c}' for e, (_, _, c) in grads.items())}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return phase


def timed_train(model, data_cfg, steps, warmup, kernels, what):
    """`train_loop` on the card for `steps` steps (log every step), the
    launch counters zeroed just before and read just after.  Each step's
    time runs from the batch hook (after a synchronize, with the step's
    batch on the card) to its log line (after the loss was read, which
    waits for the card).  Returns (losses, step ms, peak GiB since the
    state's construction, launches)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainLoopConfig, train_loop

    begins, ends = [], []

    def hook(batch):
        torch.cuda.synchronize()
        begins.append(time.perf_counter())
        return batch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    _, hist = train_loop(model, data_cfg, TrainLoopConfig(steps=steps, warmup=warmup, log_every=1, ckpt_every=10**6),
                         AdamWConfig(**TRAIN_OPT), batch_hook=hook, log=lambda _: ends.append(time.perf_counter()))
    counts = nonzero_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(hist) != steps or not all(np.isfinite(hist)):
        raise AssertionError(f"{what}: losses {hist}")
    return hist, [(e - b) * 1e3 for b, e in zip(begins, ends)], peak, counts


def report_train(what, hist, ms, peak, counts, tokens, steps):
    timed = ms[1:]
    step_ms = statistics.median(timed)
    a_step = {k: v // steps for k, v in counts.items()}
    print(f"  {what}: losses {' '.join(f'{x:.4f}' for x in hist)}; step_ms={step_ms:.1f} (median of steps "
          f"2-{steps}: {' '.join(f'{x:.1f}' for x in timed)}; step 1 {ms[0]:.1f}) tokens/s={tokens / step_ms * 1e3:.0f} "
          f"peak_GB={peak:.2f} launches a step {sum(a_step.values())} {a_step}", flush=True)
    return step_ms


def training_full(rng, dev, GemmPolicy, kernels):
    """Phase 9b: mamba2-130m as published (24 layers, d_model 768, vocab
    50280), float32, remat on, B = 8 x S = 256: layer 0's linears at the
    train shape card == cpu; one step on each engine from the same
    card-drawn weights (step-0 loss and grad_norm, emulated against native,
    within TRAIN_ENGINE_RTOL); 6 steps of `train_loop` on native and
    `kernel`, timed (launches 16 a linear a step); the resume (deterministic
    algorithms): 3 steps, a blocking save, a restore bitwise equal to the
    live state and the next step's loss and state equal from both.
    Returns the main-path launches by kernel."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.policy import NATIVE
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, cosine_warmup
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_state
    from repro_torch.tree import tree_leaves

    emu = GemmPolicy(backend="ozaki2_f32", execution="kernel")
    cfg = get_config(TRAIN_ARCH, dtype="float32")
    opt = AdamWConfig(**TRAIN_OPT)
    data = DataConfig(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
    src = SyntheticLM(data)
    batch = lambda i: {k: torch.from_numpy(v).to(dev) for k, v in src.batch(i).items()}  # noqa: E731
    schedule = cosine_warmup(TRAIN_WARMUP, TRAIN_STEPS)
    models = {"native": Model(dataclasses.replace(cfg, gemm_policy=NATIVE)),
              "kernel": Model(dataclasses.replace(cfg, gemm_policy=emu))}
    phase = {}

    params, _ = init_state(models["kernel"], opt, torch.Generator().manual_seed(0), dev)
    if count_linears(params) != TRAIN_LINEARS:
        raise AssertionError(f"{TRAIN_ARCH}: {count_linears(params)} emulated linears, expected {TRAIN_LINEARS}")
    print(f"  {TRAIN_ARCH} as published: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B params, float32, remat {cfg.remat}, "
          f"B={TRAIN_B} x S={TRAIN_S}, {TRAIN_LINEARS} emulated linears", flush=True)
    train_linears(rng, dev, layer_linears(params["groups"][0], 0), emu, TRAIN_B, TRAIN_S,
                  f"{TRAIN_ARCH} layer 0's")
    del params

    # step 0 on each engine, from the same card-drawn weights
    first = {}
    for name, model in models.items():
        params, state = init_state(model, opt, torch.Generator().manual_seed(0), dev)
        kernels.reset_launches()
        _, _, met = make_train_step(model, opt, schedule)[0](params, state, batch(0))
        counts = nonzero_counts(kernels)
        if name == "kernel":
            check_train_launches(counts, train_expect("kernel"), TRAIN_LINEARS, 1, f"{TRAIN_ARCH} kernel step 0")
            add_counts(phase, counts)
        elif counts:
            raise AssertionError(f"{TRAIN_ARCH} native: launched {counts}")
        first[name] = {k: float(v) for k, v in met.items()}
        del params, state
    for key in ("loss", "grad_norm"):
        got, want = first["kernel"][key], first["native"][key]
        if not abs(got - want) <= TRAIN_ENGINE_RTOL * abs(want):
            raise AssertionError(f"{TRAIN_ARCH} step 0 {key}: kernel {got!r} against native {want!r}")
    print(f"  {TRAIN_ARCH} step 0: loss kernel {first['kernel']['loss']:.6f} native {first['native']['loss']:.6f}, "
          f"grad_norm kernel {first['kernel']['grad_norm']:.6f} native {first['native']['grad_norm']:.6f} (within "
          f"{TRAIN_ENGINE_RTOL} relative)", flush=True)

    # 6 steps of train_loop on each engine, timed
    times = {}
    for name, model in models.items():
        hist, ms, peak, counts = timed_train(model, data, TRAIN_STEPS, TRAIN_WARMUP, kernels, f"{TRAIN_ARCH} {name}")
        if name == "kernel":
            check_train_launches(counts, train_expect("kernel"), TRAIN_LINEARS, TRAIN_STEPS, f"{TRAIN_ARCH} kernel")
            add_counts(phase, counts)
        elif counts:
            raise AssertionError(f"{TRAIN_ARCH} native: launched {counts}")
        times[name] = report_train(f"{TRAIN_ARCH} {name} train_loop", hist, ms, peak, counts, TRAIN_B * TRAIN_S,
                                   TRAIN_STEPS)
    print(f"  {TRAIN_ARCH}: the emulated step takes {times['kernel'] / times['native']:.2f}x native", flush=True)

    # one step of each engine under torch.profiler: the device's busy share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, model in models.items():
        step = make_train_step(model, opt, schedule)[0]
        params, state = init_state(model, opt, torch.Generator().manual_seed(0), dev)
        params, state, _ = step(params, state, batch(0))  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            params, state, _ = step(params, state, batch(1))
            torch.cuda.synchronize()
        events = prof.key_averages()
        device_ms = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
        kernels_ms = sum(e.self_device_time_total for e in events
                         if e.device_type == DeviceType.CUDA and any(k in e.key for k in PORT_KERNEL_FUNCTIONS)) / 1e3
        print(f"  {TRAIN_ARCH} {name} step under torch.profiler: {device_ms:.1f} ms of device time ({kernels_ms:.1f} ms "
              f"in the port's kernels), {device_ms / times[name] * 100:.1f} % of the unprofiled step's "
              f"{times[name]:.1f} ms", flush=True)
        del params, state

    # resume, under deterministic algorithms
    t0 = time.perf_counter()
    model = models["kernel"]
    step = make_train_step(model, opt, schedule)[0]
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        with deterministic():
            kernels.reset_launches()
            params, state = init_state(model, opt, torch.Generator().manual_seed(0), dev)
            for i in range(TRAIN_RESUME_AT):
                params, state, _ = step(params, state, batch(i))
            live = {"params": params, "opt": state}
            Checkpointer(ckdir).save(TRAIN_RESUME_AT, live, blocking=True)
            restored = Checkpointer(ckdir).restore(TRAIN_RESUME_AT, live, dev)
            pairs = list(zip(tree_leaves(live), tree_leaves(restored)))
            for a, b in pairs:
                if b.device.type != dev.type or not same_bits(a, b):
                    raise AssertionError(f"{TRAIN_ARCH} resume: a restored leaf {tuple(a.shape)} differs from the "
                                         f"saved one")
            _, r_state, r_met = step(restored["params"], restored["opt"], batch(TRAIN_RESUME_AT))
            _, l_state, l_met = step(params, state, batch(TRAIN_RESUME_AT))
            counts = nonzero_counts(kernels)
        check_train_launches(counts, train_expect("kernel"), TRAIN_LINEARS, TRAIN_RESUME_AT + 2,
                             f"{TRAIN_ARCH} resume steps")
        add_counts(phase, counts)
        if not same_bits(r_met["loss"], l_met["loss"]) or not all(
                same_bits(a, b) for a, b in zip(tree_leaves(r_state), tree_leaves(l_state))):
            raise AssertionError(f"{TRAIN_ARCH} resume: step {TRAIN_RESUME_AT} from the restored state gave loss "
                                 f"{float(r_met['loss'])!r}, from the live state {float(l_met['loss'])!r}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"  {TRAIN_ARCH} kernel resume (deterministic algorithms): saved at step {TRAIN_RESUME_AT} (blocking), "
          f"{len(pairs)} restored leaves bitwise the saved ones; step {TRAIN_RESUME_AT} from the restored state: "
          f"loss {float(r_met['loss']):.6f}, bitwise the live state's, and so is every leaf of the next state, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return phase


def training_wide(rng, dev, GemmPolicy, kernels):
    """Phase 9c: starcoder2-3b at full width (d_model 3072, d_ff 12288,
    vocab 49152), 2 of its 30 layers, float32, B = 4 x S = 256, on native
    and `kernel`: layer 0's linears at the train shape card == cpu
    (sampled rows and columns); 2 steps of `train_loop` each from the same card-drawn
    weights, the step-0 losses within TRAIN_ENGINE_RTOL.  Returns the
    main-path launches by kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import NATIVE
    from repro_torch.data import DataConfig
    from repro_torch.models import Model

    published = get_config(TRAIN_WIDE_ARCH)
    cfg = dataclasses.replace(published, dtype="float32", n_layers=TRAIN_WIDE_LAYERS)
    data = DataConfig(cfg.vocab, TRAIN_WIDE_S, TRAIN_WIDE_B, seed=0)
    print(f"  {TRAIN_WIDE_ARCH}: {TRAIN_WIDE_LAYERS} of {published.n_layers} layers (its params, grads, moments and "
          f"master copy at 30 layers would take ~61 GB before activations), d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, float32, B={TRAIN_WIDE_B} x S={TRAIN_WIDE_S}", flush=True)
    emu = GemmPolicy(backend="ozaki2_f32", execution="kernel")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device=dev)
    train_linears(rng, dev, layer_linears(params["groups"][0], 0), emu, TRAIN_WIDE_B, TRAIN_WIDE_S,
                  f"{TRAIN_WIDE_ARCH} layer 0's", sampled=True)
    del params
    phase, losses = {}, {}
    for name, pol in (("native", NATIVE), ("kernel", emu)):
        model = Model(dataclasses.replace(cfg, gemm_policy=pol))
        hist, ms, peak, counts = timed_train(model, data, TRAIN_WIDE_STEPS, TRAIN_WIDE_STEPS, kernels,
                                             f"{TRAIN_WIDE_ARCH} {name}")
        if name == "kernel":
            check_train_launches(counts, train_expect("kernel"), TRAIN_WIDE_LINEARS, TRAIN_WIDE_STEPS,
                                 f"{TRAIN_WIDE_ARCH} kernel")
            add_counts(phase, counts)
        elif counts:
            raise AssertionError(f"{TRAIN_WIDE_ARCH} native: launched {counts}")
        report_train(f"{TRAIN_WIDE_ARCH} ({TRAIN_WIDE_LAYERS} layers) {name} train_loop", hist, ms, peak, counts,
                     TRAIN_WIDE_B * TRAIN_WIDE_S, TRAIN_WIDE_STEPS)
        losses[name] = hist[0]
    rel = abs(losses["kernel"] - losses["native"]) / abs(losses["native"])
    if not rel <= TRAIN_ENGINE_RTOL:
        raise AssertionError(f"{TRAIN_WIDE_ARCH} step 0 loss: kernel {losses['kernel']!r} against native "
                             f"{losses['native']!r}: {rel:.3e} relative > {TRAIN_ENGINE_RTOL}")
    print(f"  {TRAIN_WIDE_ARCH} step 0 loss: kernel {losses['kernel']:.6f} native {losses['native']:.6f} ({rel:.2e} "
          f"relative, bound {TRAIN_ENGINE_RTOL})", flush=True)
    return phase


def train_cli():
    """Phase 9d: the train CLI in subprocesses on the card: 10 steps into a
    checkpoint directory (its ckpt_every, max(10, steps // 4), saves step
    10), then 12 on the same one, which must resume at step 10 and run
    exactly steps 10 and 11."""
    import os
    import shutil

    root = pathlib.Path(__file__).resolve().parent
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-130m", "--backend", "ozaki2_f32",
            "--execution", "kernel", "--batch", "2", "--seq", "32", "--ckpt-dir", ckdir]
    t0 = time.perf_counter()
    try:
        outs = []
        for steps in CLI_STEPS:
            r = subprocess.run(base + ["--steps", str(steps)], capture_output=True, text=True, env=env, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"train CLI --steps {steps} exited {r.returncode}:\n{r.stdout}\n{r.stderr}")
            outs.append(r.stdout.splitlines())
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    steps = [[line.split() for line in out if line.startswith("step ")] for out in outs]
    first, then = CLI_STEPS
    want = [[str(i) for i in range(first)], [str(i) for i in range(first, then)]]
    if ([[s[1] for s in run] for run in steps] != want
            or outs[1][0] != f"[resume] restored step {first} from {ckdir}"
            or not all(np.isfinite(float(s[3])) and np.isfinite(float(s[5])) for run in steps for s in run)):
        raise AssertionError(f"train CLI: the runs printed {outs}")
    print(f"  python -m repro_torch.launch.train --arch mamba2-130m --backend ozaki2_f32 --execution kernel --steps "
          f"{first} --batch 2 --seq 32 --ckpt-dir DIR, then --steps {then}: exit 0 twice, '{outs[1][0]}', steps "
          f"{first}-{then - 1} only; "
          f"{outs[0][-1]} / {outs[1][-1]} in {time.perf_counter() - t0:.1f} s", flush=True)


# phase 10: the sharded execution, its ranks subprocesses of this script on
# the one card (RANK_TIMEOUT s a world at most).  NCCL refuses two ranks on
# one card, so a world of 1 runs over NCCL and worlds of 2 and 4 over gloo
# (`launch.mesh.init_world` chooses).  Each case: (routine, m = n = k, mode,
# execution, mesh (data, model, residue)); N is the routine's default.
SHARD_CASES = (
    [(r, 2048, "fast", "sharded", (1, 1, 1)) for r in ROUTINES]
    + [(r, 2048, "fast", "sharded", mesh) for mesh in ((1, 1, 2), (2, 1, 1), (1, 2, 1), (1, 1, 4), (2, 2, 1))
       for r in ROUTINES]
    + [("sgemm", 2048, "fast", "fused", (2, 1, 1)), ("zgemm", 2048, "fast", "fused", (1, 2, 1))]
    + [("sgemm", 4096, "fast", "sharded", (1, 1, 2)), ("zgemm", 4096, "fast", "sharded", (1, 1, 2)),
       ("zgemm", 4096, "accu", "sharded", (2, 1, 2))]
)
SHARD_NAMES = ("data", "model", "residue")
SHARD_SERVE_LAYERS = 2  # 10b: starcoder2-3b at full width, 2 of its 30 layers, on (1, 1, 2)
SHARD_SERVE_WORLD = 2  # 10b runs in 10a's world of 2, after its GEMMs
SHARD_SERVE_CLI = ["--arch", "starcoder2-3b", "--backend", "ozaki2_f32", "--batch", "2", "--prompt-len", "16",
                   "--new-tokens", "4"]
SHARD_TRAIN_CLI = ["--arch", "mamba2-130m", "--backend", "ozaki2_f32", "--steps", "3", "--batch", "2",
                   "--seq", "32"]
RANK_TIMEOUT = 300


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_operands(routine, size, dev):
    """phi-generator operands (m = n = k = size) drawn on `dev` from a
    generator seeded by the case: the same tensors in every process."""
    gen = torch.Generator(device=dev).manual_seed(SEED + size + list(ROUTINES).index(routine))

    def phi(shape):
        u = torch.rand(shape, dtype=torch.float64, device=dev, generator=gen) - 0.5
        return u * torch.exp(torch.randn(shape, dtype=torch.float64, device=dev, generator=gen) * PHI)

    dtype = {np.float32: torch.float32, np.float64: torch.float64, np.complex64: torch.complex64,
             np.complex128: torch.complex128}[ROUTINES[routine]]
    if dtype.is_complex:
        return [torch.complex(phi((size, size)), phi((size, size))).to(dtype) for _ in range(2)]
    return [phi((size, size)).to(dtype) for _ in range(2)]


def shard_policy(GemmPolicy, routine, mode, execution, mesh=None):
    backend = {"sgemm": "ozaki2_f32", "dgemm": "ozaki2_f64", "cgemm": "ozaki2_c64", "zgemm": "ozaki2_c128"}[routine]
    return GemmPolicy(backend=backend, mode=mode, execution=execution, mesh=mesh)


def shard_serve_model(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch

    cfg = dataclasses.replace(get_config("starcoder2-3b", dtype="float32"), n_layers=SHARD_SERVE_LAYERS)
    return cfg, prompt_batch(cfg, SERVE_B, SERVE_PROMPT, np.random.default_rng(SEED), dev)


def timed_generate(eng, batch, dev):
    """A warm-up token, then the whole generate with the prefill's end
    marked: (tokens, logits, prefill ms, decode ms a token)."""
    eng.generate(batch, 1)
    marks, prefill = [], eng.model.prefill

    def marked(*args, **kwargs):
        out = prefill(*args, **kwargs)
        _sync(dev)
        marks.append(time.perf_counter())
        return out

    eng.model.prefill = marked
    try:
        _sync(dev)
        t0 = time.perf_counter()
        tok, logits = eng.generate(batch, SERVE_NEW, return_logits=True)
        _sync(dev)
        t1 = time.perf_counter()
    finally:
        del eng.model.prefill
    return tok, logits, (marks[0] - t0) * 1e3, (t1 - marks[0]) * 1e3 / SERVE_NEW


def run_ranks(tasks, world, tmp, dev):
    """`world` ranks of this script, each running `tasks` in turn, joined by
    the launcher's environment variables (rank 0's address on this host);
    the results by task and rank.  A rank that fails or outlives
    RANK_TIMEOUT fails the phase."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, __file__, "--rank-task", ",".join(tasks), str(tmp), dev.type],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + RANK_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{tasks}: rank {rank} of {world} exited {p.returncode}:\n{out[-6000:]}")
    return {task: [json.loads((tmp / f"{task}.rank{rank}.json").read_text()) for rank in range(world)]
            for task in tasks}


def sharded_phase(dev, GemmPolicy, linalg, tmp):
    """Phases 10a and 10b.  Here, on one process: each GEMM case's `kernel`
    output (saved, and timed) and starcoder2-3b's kernel engine (its
    tokens and logits saved, timed).  Then each world's ranks run their
    cases sharded (the world of 2 also serves the model on (1, 1, 2)),
    holding every rank's outputs against these with `same_bits`.  Returns
    rank 0's launches."""
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    kernel_ms = {}
    for routine, size, mode, _, _ in SHARD_CASES:
        if (routine, size, mode) not in kernel_ms:
            a, b = card_operands(routine, size, dev)
            pol = shard_policy(GemmPolicy, routine, mode, "kernel")
            linalg.matmul(a, b, policy=pol, device=dev)
            _sync(dev)
            t = time.perf_counter()
            y = linalg.matmul(a, b, policy=pol, device=dev)
            _sync(dev)
            kernel_ms[routine, size, mode] = (time.perf_counter() - t) * 1e3
            torch.save(y.cpu(), tmp / f"want_{routine}_{size}_{mode}.pt")
            del a, b, y
    cfg, batch = shard_serve_model(dev)
    eng = ServeEngine(Model(dataclasses.replace(cfg, gemm_policy=GemmPolicy(backend="ozaki2_f32",
                                                                              execution="kernel"))),
                      Model(cfg).init(torch.Generator().manual_seed(0), device=dev), SERVE_PROMPT + SERVE_NEW,
                      SERVE_B, device=dev)
    tok, logits, prefill_ms, decode_ms = timed_generate(eng, batch, dev)
    torch.save({"tokens": tok.cpu(), "logits": logits.cpu()}, tmp / "want_serve.pt")
    print(f"  here, one process on `kernel`: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}), B = "
          f"{SERVE_B}, {SERVE_PROMPT}-token prompts, {SERVE_NEW} new: prefill {prefill_ms:.1f} ms, decode "
          f"{decode_ms:.1f} ms a token", flush=True)
    del eng, tok, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launches = {}
    for world in sorted({int(np.prod(c[4])) for c in SHARD_CASES}):
        t0 = time.perf_counter()
        tasks = ["gemms"] + (["serving"] if world == SHARD_SERVE_WORLD else [])
        results = run_ranks(tasks, world, tmp, dev)
        for rank, res in enumerate(results["gemms"]):
            for line in res["cases"]:
                if not line["same_bits"]:
                    raise AssertionError(f"10a rank {rank} of {world}: {line}")
                check_rank_analysis(line, rank, world)
        for line in results["gemms"][0]["cases"]:
            print(f"  10a {line['routine']} {line['size']}^3 {line['mode']} {line['execution']} on mesh "
                  f"{tuple(line['mesh'])} ({world} ranks, {line['backend']}): {line['ms']:.2f} ms (one process "
                  f"on `kernel` {kernel_ms[line['routine'], line['size'], line['mode']]:.2f}), "
                  f"{line['allreduce_bytes'] / 2**20:.1f} MiB all-reduced, collectives {line['collective_ms']:.2f} "
                  f"ms ({100 * line['collective_ms'] / line['ms']:.1f} %), every rank bitwise the kernel output",
                  flush=True)
        for rank, res in enumerate(results.get("serving", [])):
            if not res["same_bits"]:
                raise AssertionError(f"10b rank {rank}: {res}")
            print(f"  10b rank {rank}: {cfg.name} on mesh (1, 1, 2) ({res['backend']}): prefill "
                  f"{res['prefill_ms']:.1f} ms, decode {res['decode_ms']:.1f} ms a token, tokens and logits "
                  f"bitwise the kernel engine's", flush=True)
        for res in results.values():
            add_counts(launches, res[0]["launches"])
        print(f"  world of {world}: {time.perf_counter() - t0:.1f} s with the ranks' start", flush=True)
    return launches


def check_rank_analysis(line, rank, world):
    """A traced case of 10a on one rank: no collective-safety finding, the
    f64 SUM of the partials (and in accurate mode the int32 MAX of the
    bound maxima) among its collectives, its output bitwise the kernel's."""
    key = (line["routine"], line["size"], line["mode"], tuple(line["mesh"]))
    if key not in TRACED_SHARD_CASES:
        return
    got = line.get("analysis")
    need = {("sum", "torch.float64")} | ({("max", "torch.int32")} if line["mode"] == "accu" else set())
    if got is None or got["findings"] or not need <= {tuple(c) for c in got["collectives"]} or not got["same_bits"]:
        raise AssertionError(f"10a rank {rank} of {world}, traced {key}: {got}")
    if rank == 0:
        print(f"  10a {key[0]} {key[1]}^3 {key[2]} on mesh {key[3]} traced on each of {world} ranks: no "
              f"collective-safety finding, collectives {got['collectives']}, output bitwise the kernel's",
              flush=True)


def rank_gemms(dev, tmp):
    """Rank side of 10a: this world's cases, a warm-up call for each
    routine and execution's first, then each timed call, its collectives
    logged and timed."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import repro_torch.kernels as kernels
    from repro_torch import GemmPolicy, linalg
    from repro_torch.analysis import CollectiveSafetyPass, trace
    from repro_torch.distributed import sharded_gemm

    world = dist.get_world_size()
    coll = [0.0]
    real = sharded_gemm.collective

    def timed(*args, **kwargs):
        _sync(dev)
        t = time.perf_counter()
        out = real(*args, **kwargs)
        _sync(dev)
        coll[0] += time.perf_counter() - t
        return out

    sharded_gemm.collective = timed
    kernels.reset_launches()
    meshes, warm, lines = {}, set(), []
    for routine, size, mode, execution, shape in SHARD_CASES:
        if int(np.prod(shape)) != world:
            continue
        if shape not in meshes:
            meshes[shape] = DeviceMesh(dev.type, torch.arange(world).reshape(shape), mesh_dim_names=SHARD_NAMES)
        a, b = card_operands(routine, size, dev)
        pol = shard_policy(GemmPolicy, routine, mode, execution, meshes[shape])
        if (routine, execution) not in warm:
            warm.add((routine, execution))
            linalg.matmul(a, b, policy=pol, device=dev)
        _sync(dev)
        coll[0] = 0.0
        with sharded_gemm.CollectiveLog() as log:
            t = time.perf_counter()
            y = linalg.matmul(a, b, policy=pol, device=dev)
            _sync(dev)
            ms = (time.perf_counter() - t) * 1e3
        want = torch.load(tmp / f"want_{routine}_{size}_{mode}.pt").to(dev)
        same = same_bits(y, want)
        lines.append({"routine": routine, "size": size, "mode": mode, "execution": execution, "mesh": shape,
                      "backend": dist.get_backend(), "ms": ms, "collective_ms": coll[0] * 1e3,
                      "allreduce_bytes": sum(int(np.prod(s)) * 8 for op, _, s, _ in log.calls if op == "sum"),
                      "collectives": [[op, str(dt), list(s), d] for op, dt, s, d in log.calls],
                      "same_bits": same, "difference": None if same else first_difference(y, want)})
        if (routine, size, mode, shape) in TRACED_SHARD_CASES:  # the analysis's view of the same call
            tr = trace(lambda x, w: linalg.matmul(x, w, policy=pol, device=dev), a, b)
            lines[-1]["analysis"] = {"findings": [str(f) for f in CollectiveSafetyPass().run(tr)],
                                     "collectives": sorted({(c.op, str(c.dtype)) for c in tr.collectives}),
                                     "same_bits": same_bits(tr.result, want)}
            del tr
        del a, b, y, want
    sharded_gemm.collective = real
    return {"cases": lines, "launches": kernels.launch_counts()}


def rank_serving(dev, tmp):
    """Rank side of 10b: the sharded engine on (1, 1, 2), timed as here."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import repro_torch.kernels as kernels
    from repro_torch import GemmPolicy
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    cfg, batch = shard_serve_model(dev)
    mesh = DeviceMesh(dev.type, torch.arange(2).reshape(1, 1, 2), mesh_dim_names=SHARD_NAMES)
    pol = GemmPolicy(backend="ozaki2_f32", execution="sharded", mesh=mesh)
    eng = ServeEngine(Model(dataclasses.replace(cfg, gemm_policy=pol)),
                      Model(cfg).init(torch.Generator().manual_seed(0), device=dev), SERVE_PROMPT + SERVE_NEW,
                      SERVE_B, device=dev)
    kernels.reset_launches()
    tok, logits, prefill_ms, decode_ms = timed_generate(eng, batch, dev)
    want = torch.load(tmp / "want_serve.pt")
    same = same_bits(tok.cpu(), want["tokens"]) and same_bits(logits.cpu(), want["logits"])
    return {"same_bits": same, "backend": dist.get_backend(), "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "launches": kernels.launch_counts(),
            "difference": None if same else first_difference(logits.cpu(), want["logits"])}


def cli_record(kind, argv):
    """The serve (or train) CLI's main on `argv`, its tokens (or every
    step's loss) recorded: (exit code, the record)."""
    if kind == "serve":
        from repro_torch.launch import serve as cli
        from repro_torch.serve import ServeEngine

        rec, real = [], ServeEngine.generate

        def recording(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            rec.append(out.cpu().tolist())
            return out

        ServeEngine.generate = recording
        try:
            return cli.main(argv), rec
        finally:
            ServeEngine.generate = real
    from repro_torch.launch import train as cli

    rec, real = [], cli.train_loop

    def recording(*args, **kwargs):
        params, hist = real(*args, **kwargs)
        rec.extend(hist)
        return params, hist

    cli.train_loop = recording
    try:
        with deterministic():  # the embedding's backward
            return cli.main(argv), rec
    finally:
        cli.train_loop = real


def sharded_clis(dev, tmp):
    """Phase 10c: the serve and train CLIs under `python -m
    torch.distributed.run --nproc-per-node 2 --execution sharded --residue
    2`, each rank's tokens (the serve CLI) or every step's loss (the train
    CLI) equal to the same CLI's on `--execution kernel` here; rank 0
    alone prints.  Both launchers start at once, and the `kernel` runs go
    here while their ranks run (a launcher's seconds are taken beside
    them)."""
    runs = {}
    try:
        for kind, flags in (("serve", SHARD_SERVE_CLI), ("train", SHARD_TRAIN_CLI)):
            argv = flags + ["--execution", "sharded", "--residue", "2", "--device", dev.type]
            proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                                     "2", __file__, "--rank-task", f"cli_{kind}", str(tmp), dev.type, *argv],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            runs[kind] = (flags, argv, proc, time.perf_counter())
        for kind, (flags, argv, proc, t0) in runs.items():
            rc, want = cli_record(kind, flags + ["--execution", "kernel", "--device", dev.type])
            if rc != 0:
                raise AssertionError(f"the {kind} CLI on kernel exited {rc}")
            out, err = proc.communicate(timeout=max(1.0, t0 + RANK_TIMEOUT - time.perf_counter()))
            if proc.returncode != 0:
                raise AssertionError(f"torch.distributed.run of the {kind} CLI exited {proc.returncode}:\n"
                                     f"{out[-4000:]}\n{err[-6000:]}")
            printed = [line for line in out.splitlines() if line.startswith("[")]
            got = [json.loads((tmp / f"cli_{kind}.rank{rank}.json").read_text()) for rank in range(2)]
            if any(g != want for g in got) or len(printed) != 1:
                raise AssertionError(f"{kind} CLI: ranks {got} against kernel {want}; printed {printed}")
            print(f"  10c python -m torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.{kind} "
                  f"{' '.join(argv)}: exit 0 in {time.perf_counter() - t0:.1f} s (both launchers at once), "
                  f"{printed[0]!r} from rank 0 alone, both ranks' {'tokens' if kind == 'serve' else 'losses'} "
                  f"{want} bitwise --execution kernel's", flush=True)
    finally:
        for _, _, proc, _ in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


# phase 11: the static analysis (`repro_torch.analysis`) on the card.  11b's
# shape puts k past 2^17, so that the int8 products run 2 K-chunks and the
# e4m3 ones 3; there accurate mode's bound product refuses k > 2^17 (in
# the reference too), and so does `per_modulus_kernel`'s complex product,
# one launch a modulus, which neither package K-chunks: 11b runs fast mode,
# and the per-modulus execution on the real dtypes.
ANALYSIS_CHUNKED = (16, INT8_K_LIMIT + 5, 16)
ANALYSIS_EXECUTIONS = ("kernel", "per_modulus_kernel", "fused", "fp8")  # 11c, under torch.profiler
ANALYSIS_TIMEOUT = 300
# 11c profiles a call again, up to this many times in all, only where
# torch.profiler recorded no device event at all (once on the H100 a
# profile of fp8 float64 at SMOKE_SHAPE held none of the port's kernels,
# which every other run of this phase held); a profile that holds any
# device event is checked as it is
PROFILE_ATTEMPTS = 3
# each CUDA kernel function (as a profiler names it, by its identifier) and
# the wrapper whose launches it counts
KERNEL_WRAPPER = {"residue_cast_kernel": "residue_cast", "int8_mod_gemm_kernel": "int8_mod_gemm",
                  "karatsuba_kernel": "karatsuba_fused", "crt_garner_kernel": "crt_garner",
                  "fused_mod_gemm_kernel": "fused_mod_gemm", "fused_karatsuba_kernel": "fused_karatsuba",
                  "fp8_mod_gemm_kernel": "fp8_mod_gemm", "fp8_karatsuba_kernel": "fp8_karatsuba",
                  "launch_copy_kernel": "launch_copy", "fa_f32_kernel": "flash_attention",
                  "fa_bf16_kernel": "flash_attention"}
# phase 10's cases whose ranks also run under the analysis's trace
TRACED_SHARD_CASES = {("sgemm", 2048, "fast", (1, 1, 2)), ("zgemm", 4096, "accu", (2, 1, 2))}


def start_analysis_cli(argv):
    """`python -m repro_torch.analysis` with `argv` on the card, started in
    a subprocess: (argv, the process)."""
    src = str(pathlib.Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    return argv, subprocess.Popen([sys.executable, "-m", "repro_torch.analysis", *argv], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_analysis_cli(what, job, t0):
    """Wait for a started CLI: exit 0 with every row clean, or the phase
    fails."""
    argv, proc = job
    out, err = proc.communicate(timeout=max(1.0, t0 + ANALYSIS_TIMEOUT - time.perf_counter()))
    summary = out.strip().splitlines()[-1] if out.strip() else ""
    m = re.match(r"repro_torch\.analysis: (\d+)/(\d+) rows certified clean \(0 findings\) on cuda", summary)
    if proc.returncode != 0 or not m or m.group(1) != m.group(2):
        raise AssertionError(f"{what}: python -m repro_torch.analysis {' '.join(argv)} exited {proc.returncode}:\n"
                             f"{out[-6000:]}\n{err[-4000:]}")
    print(f"  {what}: python -m repro_torch.analysis {' '.join(argv)}: exit 0, {m.group(1)}/{m.group(2)} rows "
          f"certified clean (done {time.perf_counter() - t0:.1f} s into the phase)", flush=True)


def device_launches(prof):
    """The port's kernel launches the card ran under `prof`, by wrapper.  An
    event named like a port kernel (`PORT_KERNEL_FUNCTIONS`, stems that
    several sources share) whose identifier maps to no wrapper, or to more
    than one, fails the phase."""
    from torch.autograd import DeviceType

    counts = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not any(k in e.key for k in PORT_KERNEL_FUNCTIONS):
            continue
        owners = {KERNEL_WRAPPER[w] for w in re.findall(r"\b(\w+_kernel)\b", e.key) if w in KERNEL_WRAPPER}
        if len(owners) != 1:
            raise AssertionError(f"11c: profiler event {e.key!r} maps to wrappers {sorted(owners)}")
        (owner,) = owners
        counts[owner] = counts.get(owner, 0) + e.count
    return counts


def analysis_profiled(dev, GemmPolicy, linalg):
    """Phase 11c: for each execution, dtype and shape, a warm call, then one
    call traced under `torch.profiler` (again where the profile holds no
    device event at all, PROFILE_ATTEMPTS): the card's launches of each kernel
    equal to the trace's launch records of its wrapper, their total to
    `expected_launch_count`.  Returns 11b's `kernel` sgemm trace (for 11d)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis import expected_launch_count, trace
    from repro_torch.analysis.__main__ import N_MODULI, SMOKE_SHAPE, operands
    from repro_torch.core.policy import BACKEND_FOR_DTYPE

    chunked_kernel, seen = None, {}
    for shape in (SMOKE_SHAPE, ANALYSIS_CHUNKED):
        for execution in ANALYSIS_EXECUTIONS:
            for dtype_name in N_MODULI:
                if execution == "per_modulus_kernel" and dtype_name.startswith("complex") and shape[1] > INT8_K_LIMIT:
                    continue
                pol = GemmPolicy(backend=BACKEND_FOR_DTYPE[dtype_name], n_moduli=N_MODULI[dtype_name],
                                 execution=execution)
                a, b = operands(shape, dtype_name, dev)
                run = lambda x, w: linalg.matmul(x, w, policy=pol, device=dev)  # noqa: E731
                run(a, b)
                torch.cuda.synchronize()
                for attempt in range(1, PROFILE_ATTEMPTS + 1):
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        tr = trace(run, a, b)
                        torch.cuda.synchronize()
                    if any(e.device_type == DeviceType.CUDA for e in prof.key_averages()):
                        break
                    print(f"  11c {execution} {dtype_name} {shape}: torch.profiler recorded no device event at all "
                          f"(profile {attempt} of at most {PROFILE_ATTEMPTS})", flush=True)
                got = device_launches(prof)
                want = expected_launch_count(pol.execution_backend(), pol.plan_for(*shape), shape)
                if got != tr.launch_counts() or sum(got.values()) != want:
                    events = sorted({e.key[:60] for e in prof.key_averages() if e.device_type == DeviceType.CUDA})
                    raise AssertionError(f"11c {execution} {dtype_name} {shape}: the card ran {got}, the trace "
                                         f"records {tr.launch_counts()}, the perfmodel predicts {want}; the "
                                         f"profile's device events: {events}")
                seen[shape, execution, dtype_name] = got
                if (shape, execution, dtype_name) == (ANALYSIS_CHUNKED, "kernel", "float32"):
                    chunked_kernel = tr
    for shape in (SMOKE_SHAPE, ANALYSIS_CHUNKED):
        for execution in ANALYSIS_EXECUTIONS:
            cases = {d: c for (s, e, d), c in seen.items() if (s, e) == (shape, execution)}
            print(f"  11c {execution} at {shape}: the card's launches by kernel (torch.profiler) == the trace's "
                  f"== expected_launch_count: {cases}", flush=True)
    return chunked_kernel


def analysis_phase(dev, GemmPolicy, linalg):
    """Phase 11: 11a the CLI's smoke matrix and 11b the K-chunked shape (three
    subprocesses, run beside 11c), 11c the profiler's launch counts against
    the trace's, 11d a negative control: OverflowPass at half the int8
    limit flags 11b's kernel trace."""
    from repro_torch.analysis import OverflowPass
    from repro_torch.core.moduli import K_CHUNK_LIMIT

    t0 = time.perf_counter()
    shape = [str(d) for d in ANALYSIS_CHUNKED]
    # the three CLI runs share the card with 11c, each in its own process
    jobs = [("11a", start_analysis_cli(["--matrix", "smoke", "-v"])),
            ("11b", start_analysis_cli(["--executions", "kernel", "fused", "fp8", "reference", "--modes", "fast",
                                        "--shape", *shape, "--skip-model", "--skip-lint", "-v"])),
            ("11b", start_analysis_cli(["--executions", "per_modulus_kernel", "--dtypes", "float32", "float64",
                                        "--modes", "fast", "--shape", *shape, "--skip-model", "--skip-lint", "-v"]))]
    try:
        chunked_kernel = analysis_profiled(dev, GemmPolicy, linalg)
        for what, job in jobs:
            finish_analysis_cli(what, job, t0)
    finally:
        for _, (_, proc) in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ks = [r.k for r in chunked_kernel.launches if r.name == "int8_mod_gemm"]
    if ks != [INT8_K_LIMIT, 5]:
        raise AssertionError(f"11b kernel sgemm at {ANALYSIS_CHUNKED}: int8 launches over k = {ks}")
    findings = OverflowPass(k_limit=K_CHUNK_LIMIT // 2).run(chunked_kernel)
    if not findings:
        raise AssertionError("11d: OverflowPass(k_limit=K_CHUNK_LIMIT // 2) certified a launch of k = 2^17")
    print(f"  11d OverflowPass(k_limit=K_CHUNK_LIMIT // 2) over the kernel sgemm trace at {ANALYSIS_CHUNKED} "
          f"(int8 launches at k = {ks}): {len(findings)} finding, {findings[0]}", flush=True)
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)


# phase 12: the parameter-sharded training mesh (`train.step` on a
# DeviceMesh), its ranks subprocesses of this script sharing the card over
# gloo (run_ranks: one world of 4; a case on fewer ranks runs on the first
# ones), under deterministic algorithms.  Each case: (model, mesh (data,
# model, residue), execution of its linears, steps, B (None: the model's));
# the one-process step it is held to runs grad_accum = D on `kernel`.  12b
# takes one step at B 1: each of its 192 GEMMs all-reduces its float64
# partial planes over gloo (9.1 GiB a step at B 8, 17.6 s; 3.3 GiB at B 2,
# 11.4-13.7 s).
MESH_TRAIN_CASES = (
    ("mamba2", (2, 1, 1), "kernel", 2, None), ("mamba2", (1, 2, 1), "kernel", 2, None),
    ("mamba2", (1, 1, 2), "sharded", 1, 1), ("mamba2", (2, 2, 1), "kernel", 2, None),
    ("starcoder2", (2, 2, 1), "kernel", 1, None),
)
MESH_WORLD = 4
MESH_TRAIN_LINEARS = {"mamba2": TRAIN_LINEARS, "starcoder2": TRAIN_WIDE_LINEARS}
COMPRESS_RANKS = (2, 4)  # 12d: error_feedback_psum over the first 2, then all 4 ranks
COMPRESS_SHAPE = (4096, 4096)  # one float32 grad leaf of 16.8 M values a rank
PIPE_MICRO = 4  # 12d: GPipe microbatches (tests/test_pipeline.py's)
PIPE_LOSS_RTOL = 1e-5  # 12d: the pipelined loss against the sequential one, relative
# 12c: the train CLI on mamba2-130m as published: 3 steps on the mesh; the
# checkpoint its resume reads comes from one process (the CLI's
# ckpt_every, max(10, steps // 4), saves nothing before step 10), which
# takes 10 steps while the mesh run runs; the resume goes to step 12
MESH_CLI = ["--arch", "mamba2-130m", "--full", "--backend", "ozaki2_f32", "--execution", "kernel"]
MESH_CLI_STEPS = (3, 10, 12)
# the fingerprint of a tensor's bits: FINGERPRINT_WAYS sums, each of every
# 32- (or 16-, 8-) bit word times a weight drawn from a seeded generator,
# in exact integer arithmetic modulo the prime 2^31 - 1, a chunk of words
# at a time; two tensors whose bits differ anywhere agree in one way with
# chance 2^-31
FINGERPRINT_PRIME, FINGERPRINT_WAYS, FINGERPRINT_CHUNK = 2**31 - 1, 4, 1 << 24


def mesh_train_model(which, GemmPolicy, execution="kernel", batch=None):
    """12a's models: mamba2-130m as published (the train CLI's B 8 x S
    256) or starcoder2-3b at full width, 2 of 30 layers (9c's B 4 x S
    256), float32, every linear on `execution`; `batch` replaces B.
    (config, data config)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig

    pol = GemmPolicy(backend="ozaki2_f32", execution=execution)
    if which == "mamba2":
        cfg = get_config(TRAIN_ARCH, dtype="float32", gemm_policy=pol)
        return cfg, DataConfig(cfg.vocab, TRAIN_S, batch or TRAIN_B, seed=0)
    cfg = get_config(TRAIN_WIDE_ARCH, dtype="float32", n_layers=TRAIN_WIDE_LAYERS, gemm_policy=pol)
    return cfg, DataConfig(cfg.vocab, TRAIN_WIDE_S, batch or TRAIN_WIDE_B, seed=0)


def fingerprint(t: torch.Tensor) -> list:
    """The fingerprint of `t`'s bits (FINGERPRINT_WAYS residues mod
    FINGERPRINT_PRIME), computed where `t` lies: the same in every process
    for the same bits, a zero's sign included."""
    words = t.detach().reshape(-1).contiguous().view(
        {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int32}[t.element_size()])
    out = []
    for way in range(FINGERPRINT_WAYS):
        gen = torch.Generator(device=words.device).manual_seed(SEED + 12 + way)
        acc = 0
        for lo in range(0, words.numel(), FINGERPRINT_CHUNK):
            x = words[lo:lo + FINGERPRINT_CHUNK].to(torch.int64).remainder(FINGERPRINT_PRIME)
            w = torch.randint(1, FINGERPRINT_PRIME, x.shape, generator=gen, device=x.device, dtype=torch.int64)
            acc += int(torch.remainder(x * w, FINGERPRINT_PRIME).sum())  # each product < 2^62
        out.append(acc % FINGERPRINT_PRIME)
    return out


def state_fingerprint(tree) -> list:
    """Each leaf's `fingerprint`, in leaf order."""
    from repro_torch.tree import tree_leaves

    return [fingerprint(t) for t in tree_leaves(tree)]


def mesh_train_references(dev, GemmPolicy):
    """12a's one-process steps on the card (deterministic algorithms): for
    each (model, grad_accum, B) a case needs, as many steps as its longest
    case: every step's loss and time, and the state's fingerprint after
    each step a case ends at."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_state

    ends = {}
    for which, shape, _, steps, rows in MESH_TRAIN_CASES:
        ends.setdefault((which, shape[0], rows), set()).add(steps)
    refs = {}
    for (which, accum, rows), stops in ends.items():
        cfg, data = mesh_train_model(which, GemmPolicy, batch=rows)
        model, src = Model(cfg), SyntheticLM(data)
        step, _ = make_train_step(model, AdamWConfig(**TRAIN_OPT), grad_accum=accum)
        ms, losses, prints = [], [], {}
        with deterministic():
            params, state = init_state(model, AdamWConfig(**TRAIN_OPT), torch.Generator().manual_seed(0), dev)
            for i in range(max(stops)):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in src.batch(i).items()}
                _sync(dev)
                t = time.perf_counter()
                params, state, met = step(params, state, batch)
                losses.append(float(met["loss"]).hex())
                _sync(dev)
                ms.append((time.perf_counter() - t) * 1e3)
                if i + 1 in stops:
                    prints[i + 1] = state_fingerprint({"params": params, "opt": state})
        refs[which, accum, rows] = {"prints": prints, "losses": losses, "ms": ms}
        del params, state, step, model
        torch.cuda.empty_cache()
    return refs


def compress_inputs(rank, dev):
    """12d's grad and error buffer of `rank`, drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1000 + rank)
    g = torch.randn(COMPRESS_SHAPE, generator=gen, device=dev) * float(rank + 1)
    return g, torch.randn(COMPRESS_SHAPE, generator=gen, device=dev) * 1e-2


def compress_formula(world, dev):
    """The error-feedback mean of `world` ranks' grads in one process: one
    scale (the ranks' maximum), each grad quantized to it, the int32 sum,
    its mean; (fingerprint of the mean, of each rank's new error)."""
    from repro_torch.distributed.compression import quantize_int8

    g32 = [g.float() + e for g, e in (compress_inputs(r, dev) for r in range(world))]
    smax = torch.stack([quantize_int8(x)[1] for x in g32]).max()
    q = [torch.clamp(torch.round(x / smax), -127, 127).to(torch.int32) for x in g32]
    errs = [x - qi.to(torch.float32) * smax for x, qi in zip(g32, q)]
    total = q[0]
    for qi in q[1:]:
        total = total + qi
    mean = total.to(torch.float32) * smax / torch.tensor(float(world), device=dev)
    return state_fingerprint(mean)[0], state_fingerprint(errs)


def mesh_training(dev, GemmPolicy, tmp):
    """Phases 12a, 12b and 12d: the one-process references here, then a
    world of 4 ranks: each mesh case's steps on its first ranks,
    compression over 2 and 4, the pipeline over 2.  Every rank's gathered
    state and losses bitwise the reference's (equal fingerprints).
    Returns rank 0's launches of the cases and its lines (phase 13b holds
    the dry run's collectives to them)."""
    refs = mesh_train_references(dev, GemmPolicy)
    t0 = time.perf_counter()
    results = run_ranks(["mesh_train", "compress", "pipeline"], MESH_WORLD, tmp, dev)
    print(f"  {MESH_WORLD} ranks: {time.perf_counter() - t0:.1f} s with their start", flush=True)
    launches = {}
    for rank, res in enumerate(results["mesh_train"]):
        for line in res["cases"]:
            ref = refs[line["model"], line["mesh"][0], line["batch"]]
            want = ref["prints"][line["steps"]]
            if line["prints"] != want or line["losses"] != ref["losses"][:line["steps"]]:
                bad = [i for i, (a, b) in enumerate(zip(line["prints"], want)) if a != b]
                raise AssertionError(f"12a rank {rank}, {line['model']} on {tuple(line['mesh'])} "
                                     f"{line['execution']}: losses {line['losses']} against {ref['losses']}, "
                                     f"leaves differing {bad[:10]} of {len(want)}")
            check_train_launches(line["launches"], train_expect("kernel"), MESH_TRAIN_LINEARS[line["model"]],
                                 line["steps"], f"12a rank {rank} {line['model']} on {tuple(line['mesh'])}")
    for line in results["mesh_train"][0]["cases"]:
        ref = refs[line["model"], line["mesh"][0], line["batch"]]
        phase = "12b" if line["execution"] == "sharded" else "12a"
        print(f"  {phase} {line['model']} on mesh {tuple(line['mesh'])} ({int(np.prod(line['mesh']))} ranks, "
              f"{line['backend']}, {line['execution']}, B {line['rows']}): {line['steps']} steps, losses "
              f"{' '.join(f'{float.fromhex(x):.6f}' for x in line['losses'])}; step ms "
              f"{' '.join(f'{x:.1f}' for x in line['ms'])} (one process, grad_accum {line['mesh'][0]}: "
              f"{' '.join(f'{x:.1f}' for x in ref['ms'][:line['steps']])}); a step "
              f"{line['gathered_bytes'] / 2**20:.1f} MiB gathered by broadcasts and "
              f"{line['reduced_bytes'] / 2**20:.1f} MiB all-reduced, collectives {line['collective_ms']:.1f} ms "
              f"({100 * line['collective_ms'] / line['ms'][-1]:.1f} % of the last step); every rank's "
              f"{len(line['prints'])} state leaves and losses bitwise the one-process step", flush=True)
        add_counts(launches, line["launches"])
    rank0 = results["mesh_train"][0]["cases"]
    for world in COMPRESS_RANKS:
        mean, errs = compress_formula(world, dev)
        for rank, res in enumerate(results["compress"][:world]):
            line = res[str(world)]
            if line["mean"] != mean or line["err"] != errs[rank]:
                raise AssertionError(f"12d compression, rank {rank} of {world}: differs from the one-process formula")
        print(f"  12d error_feedback_psum over {world} ranks, {COMPRESS_SHAPE} float32 a rank: "
              f"{results['compress'][0][str(world)]['ms']:.1f} ms; every rank's mean and new error bitwise the "
              f"one-process formula", flush=True)
    for rank, res in enumerate(results["pipeline"][:2]):
        if not res["ok"]:
            raise AssertionError(f"12d pipeline rank {rank}: {res}")
        print(f"  12d pipeline_loss, {TRAIN_WIDE_ARCH} at full width, {TRAIN_WIDE_LAYERS} layers, pp = 2, "
              f"{PIPE_MICRO} microbatches, rank {rank} (stage {res['stage']}): loss {res['loss']:.6f} against "
              f"the sequential model's at the same microbatches {res['mb_loss']:.6f} ({res['loss_rel']:.2e} "
              f"relative, bound {PIPE_LOSS_RTOL}), grads of its {res['leaves']} leaves within "
              f"{res['worst']:.3f} of max(1e-5, 1e-3 max|g|); against the whole-batch model (loss "
              f"{res['seq_loss']:.6f}, {res['full_loss_rel']:.2e} relative) the grads read {res['full_worst']:.2f} "
              f"of that bound, the microbatched sequential model's own {res['mb_full_worst']:.2f}; loss and "
              f"grads {res['pipe_ms']:.1f} ms (sequential {res['mb_ms']:.1f} microbatched, {res['seq_ms']:.1f} "
              f"whole)", flush=True)
    return launches, rank0


def rank_mesh_train(dev, tmp):
    """Rank side of 12a and 12b: every case (on the first ranks of the
    world; the others build its mesh and wait), each step timed, its
    collectives logged and timed; then the state gathered and
    fingerprinted."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import repro_torch.kernels as kernels
    from repro_torch import GemmPolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharded_gemm
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.analysis.trace import Collective
    from repro_torch.launch.dryrun import collective_summary
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_state
    from repro_torch.tree import tree_map

    coll = [0.0]
    real = sharded_gemm.collective

    def timed(*args, **kwargs):
        _sync(dev)
        t = time.perf_counter()
        out = real(*args, **kwargs)
        _sync(dev)
        coll[0] += time.perf_counter() - t
        return out

    # every rank's first CUDA work at once, before any case (a rank's first
    # case otherwise pays it, and the cases of 4 ranks wait for the last 2):
    # reduced mamba2-130m's loss and grads on `kernel` (the emulated
    # products, the conv, the scan, the embedding's backward)
    from repro_torch.configs import get_reduced
    from repro_torch.train.step import loss_and_grads

    warm = Model(get_reduced(TRAIN_ARCH, dtype="float32", gemm_policy=GemmPolicy(backend="ozaki2_f32",
                                                                                  execution="kernel")))
    with deterministic():
        loss_and_grads(warm, warm.init(torch.Generator().manual_seed(0), device=dev),
                       {"tokens": torch.zeros((2, 32), dtype=torch.int32, device=dev)})
    _sync(dev)
    lines = []
    for which, shape, execution, steps, rows in MESH_TRAIN_CASES:
        mesh = DeviceMesh(dev.type, torch.arange(int(np.prod(shape))).reshape(shape), mesh_dim_names=SHARD_NAMES)
        if mesh.get_coordinate() is None:
            continue
        cfg, data = mesh_train_model(which, GemmPolicy, execution, rows)
        model, src = Model(cfg), SyntheticLM(data)
        step, sh = make_train_step(model, AdamWConfig(**TRAIN_OPT), mesh=mesh)
        ms, losses = [], []
        kernels.reset_launches()
        sharded_gemm.collective = timed
        try:
            with deterministic():
                params, state = init_state(model, AdamWConfig(**TRAIN_OPT), torch.Generator().manual_seed(0), dev, sh)
                for i in range(steps):
                    batch = {k: sh["batch"].place(torch.from_numpy(v)) for k, v in src.batch(i).items()}
                    coll[0] = 0.0
                    with sharded_gemm.CollectiveLog() as log:
                        _sync(dev)
                        t = time.perf_counter()
                        params, state, met = step(params, state, batch)
                        losses.append(float(met["loss"]).hex())
                        _sync(dev)
                        ms.append((time.perf_counter() - t) * 1e3)
                counts = nonzero_counts(kernels)
        finally:
            sharded_gemm.collective = real
        prints = state_fingerprint(tree_map(sharded_gemm.full_tensor, {"params": params, "opt": state}))
        lines.append({"model": which, "mesh": shape, "execution": execution, "steps": steps, "batch": rows,
                      "rows": data.global_batch, "ms": ms, "losses": losses, "prints": prints, "launches": counts,
                      "backend": dist.get_backend(), "collective_ms": coll[0] * 1e3,
                      "gathered_bytes": sum(int(np.prod(s)) * dt.itemsize for op, dt, s, _ in log.calls
                                            if op == "broadcast"),
                      "reduced_bytes": sum(int(np.prod(s)) * dt.itemsize for op, dt, s, _ in log.calls
                                           if op != "broadcast"),
                      "collectives": collective_summary([Collective(*c) for c in log.calls])})
        del params, state, step, model
        torch.cuda.empty_cache()
    return {"cases": lines}


def rank_compress(dev, tmp):
    """Rank side of 12d's compression: `error_feedback_psum` of this rank's
    grad over a 'data' mesh of the first 2, then all ranks, timed; the
    fingerprints of its outputs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.compression import error_feedback_psum

    out = {}
    for world in COMPRESS_RANKS:
        mesh = DeviceMesh(dev.type, torch.arange(world), mesh_dim_names=("data",))
        if mesh.get_coordinate() is None:
            continue
        g, e = compress_inputs(dist.get_rank(), dev)
        error_feedback_psum(g, e, mesh, "data")  # warm-up
        _sync(dev)
        t = time.perf_counter()
        mean, err = error_feedback_psum(g, e, mesh, "data")
        _sync(dev)
        out[world] = {"ms": (time.perf_counter() - t) * 1e3, "mean": state_fingerprint(mean)[0],
                      "err": state_fingerprint(err)[0]}
    return out


def microbatched_loss(model, params, batch, n_micro):
    """`pipeline_loss`'s computation with its stages in one process: the
    whole layer stack run on each microbatch in turn, at the pipeline's
    shapes (`pipeline._stage_fn`), then the same norm, head and mean
    cross entropy over the whole batch."""
    from repro_torch.distributed.pipeline import _stage_fn
    from repro_torch.models.layers import apply_norm

    cfg = model.cfg
    h, positions = model._embed_inputs(params, batch)
    b = h.shape[0]
    mb = h.reshape((n_micro, b // n_micro) + tuple(h.shape[1:]))
    y = torch.stack([_stage_fn(cfg, params["groups"][0], mb[m], positions[: b // n_micro]) for m in range(n_micro)])
    logits = model._head(params, apply_norm(cfg.norm, params["final_norm"], y.reshape(h.shape)))
    tokens = batch["tokens"]
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)], dim=1)
    gold = torch.take_along_dim(logits, targets.long()[..., None], dim=-1)[..., 0]
    return torch.sum((torch.logsumexp(logits, dim=-1) - gold) * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def rank_pipeline(dev, tmp):
    """Rank side of 12d's pipeline: starcoder2-3b at full width, 2 layers,
    native float32, on a (2,) 'pp' mesh: `pipeline_loss` and its grads,
    then in this process the sequential model's at the pipeline's
    microbatch shapes (`microbatched_loss`) and on the whole batch
    (`Model.loss`).  The rank's blocks (the group leaves' own stage block;
    on stage 0 the other leaves too) are held against the first, by
    tests/test_pipeline.py's bounds; against the second they are read,
    beside that of the microbatched sequential model itself: at this
    random init the residual stream grows to ~1e3, the attention logits
    saturate, and cuBLAS's other sums at the whole batch's shapes move
    the q/k grads by percents."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.core.policy import NATIVE
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed.pipeline import pipeline_loss
    from repro_torch.models import Model
    from repro_torch.tree import leaves_with_paths, unflatten

    cfg = get_config(TRAIN_WIDE_ARCH, dtype="float32", n_layers=TRAIN_WIDE_LAYERS, gemm_policy=NATIVE, remat=False)
    model = Model(cfg)
    mesh = DeviceMesh(dev.type, torch.arange(2), mesh_dim_names=("pp",))
    if mesh.get_coordinate() is None:
        return None
    stage = mesh.get_local_rank("pp")
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    batch = {"tokens": torch.from_numpy(SyntheticLM(DataConfig(cfg.vocab, TRAIN_WIDE_S, TRAIN_WIDE_B, seed=0))
                                        .batch(0)["tokens"]).to(dev)}
    paths = [p for p, _ in leaves_with_paths(params)]

    def loss_and_grads(fn):
        leaves = [t.detach().requires_grad_(True) for _, t in leaves_with_paths(params)]
        _sync(dev)
        t0 = time.perf_counter()
        loss = fn(unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        _sync(dev)
        return float(loss.detach()), [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)], \
            (time.perf_counter() - t0) * 1e3

    def worst(got, want):
        """The largest of each held leaf's max|got - want| over its bound."""
        per, out = cfg.n_layers // 2, 0.0
        for path, g, w in zip(paths, got, want):
            if path[0] == "groups":
                g, w = g[stage * per:(stage + 1) * per], w[stage * per:(stage + 1) * per]
            elif stage != 0:
                continue
            out = max(out, float((g - w).abs().max()) / max(1e-5, 1e-3 * float(w.abs().max())))
        return out

    with deterministic():
        loss, grads, pipe_ms = loss_and_grads(lambda p: pipeline_loss(model, p, batch, mesh, "pp", PIPE_MICRO))
        mb_loss, mb_grads, mb_ms = loss_and_grads(lambda p: microbatched_loss(model, p, batch, PIPE_MICRO))
        seq_loss, seq_grads, seq_ms = loss_and_grads(lambda p: model.loss(p, batch)[0])
    loss_rel = abs(loss - mb_loss) / abs(mb_loss)
    held = worst(grads, mb_grads)
    return {"stage": stage, "loss": loss, "mb_loss": mb_loss, "seq_loss": seq_loss, "loss_rel": loss_rel,
            "worst": held, "leaves": sum(1 for p in paths if p[0] == "groups" or stage == 0),
            "full_worst": worst(grads, seq_grads), "mb_full_worst": worst(mb_grads, seq_grads),
            "full_loss_rel": abs(loss - seq_loss) / abs(seq_loss), "pipe_ms": pipe_ms, "mb_ms": mb_ms,
            "seq_ms": seq_ms, "ok": loss_rel <= PIPE_LOSS_RTOL and held <= 1.0}


def cli_mesh_record(argv):
    """The train CLI's main on `argv` under deterministic algorithms: (exit
    code, {"losses": every step's loss, "restored": for each sharded
    restore, the fingerprints of the restored state gathered whole})."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.sharded_gemm import full_tensor
    from repro_torch.launch import train as cli
    from repro_torch.tree import tree_map

    losses, restores = [], []
    real_loop, real_restore = cli.train_loop, Checkpointer.restore

    def recording(*args, **kwargs):
        params, hist = real_loop(*args, **kwargs)
        losses.extend(hist)
        return params, hist

    def restore(self, step, like, device=None, shardings=None):
        out = real_restore(self, step, like, device, shardings)
        if shardings is not None:
            restores.append(state_fingerprint(tree_map(full_tensor, out)))
        return out

    cli.train_loop, Checkpointer.restore = recording, restore
    try:
        with deterministic():
            return cli.main(argv), {"losses": losses, "restored": restores}
    finally:
        cli.train_loop, Checkpointer.restore = real_loop, real_restore


def mesh_train_cli(dev, tmp):
    """Phase 12c: `--mesh 2x1` under `python -m torch.distributed.run
    --nproc-per-node 2` for 3 steps, each rank's losses bitwise one
    process's with --grad-accum 2; meanwhile one process writes a
    checkpoint at step 10 into a directory; then `--mesh 1x2` resumes from
    it to step 12: the restored state gathered bitwise the checkpoint's
    arrays, the losses bitwise one process resumed from a copy of it with
    --grad-accum 1.  Each one-process run goes here while the launcher's
    ranks run."""
    import shutil

    mesh_steps, saved_at, then = MESH_CLI_STEPS
    ckdir, one = tmp / "mesh_cli", tmp / "mesh_cli_one"
    runs = ((["--mesh", "2x1", "--steps", str(mesh_steps)], ["--grad-accum", "2", "--steps", str(mesh_steps)]),
            (["--mesh", "1x2", "--steps", str(then), "--ckpt-dir", str(ckdir)],
             ["--steps", str(then), "--ckpt-dir", str(one)]))
    saved = None
    for i, (mesh_flags, one_flags) in enumerate(runs):
        argv = MESH_CLI + mesh_flags + ["--device", dev.type]
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                                 "2", __file__, "--rank-task", "cli_mesh_train", str(tmp), dev.type, *argv],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc, want = cli_mesh_record(MESH_CLI + one_flags + ["--device", dev.type])
                if i == 0:  # the checkpoint the resume reads
                    cli_mesh_record(MESH_CLI + ["--steps", str(saved_at), "--ckpt-dir", str(ckdir),
                                                "--device", dev.type])
                    shutil.copytree(ckdir, one)
                    with np.load(ckdir / f"step_{saved_at}" / "arrays.npz") as z:
                        saved = state_fingerprint([torch.from_numpy(z[k]).to(dev) for k in z.files])
            out, err = proc.communicate(timeout=RANK_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        both_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torch.distributed.run of the train CLI {' '.join(mesh_flags)} exited "
                                 f"{proc.returncode}:\n{out[-4000:]}\n{err[-6000:]}")
        got = [json.loads((tmp / f"cli_mesh_train.rank{rank}.json").read_text()) for rank in range(2)]
        printed = [line for line in out.splitlines() if line.startswith(("[mamba2-130m]", "[resume]"))]
        restored = [g["restored"] for g in got]
        if (rc != 0 or any(g["losses"] != want["losses"] for g in got) or not want["losses"]
                or restored != [[saved] * i] * 2 or len(printed) != 1 + i):
            raise AssertionError(f"12c {' '.join(mesh_flags)}: ranks {got} against one process {want}; printed "
                                 f"{printed}")
        print(f"  12c python -m torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train "
              f"{' '.join(argv)}: exit 0, {printed} from rank 0 alone"
              f"{f', the state it restored gathered bitwise the {len(saved)} checkpoint arrays on both ranks' if i else ''}"
              f"; both ranks' {len(want['losses'])} losses ({want['losses'][0]:.6f} ... {want['losses'][-1]:.6f}) "
              f"bitwise one process's with {' '.join(one_flags)}"
              f"{f' (and a one-process run of {saved_at} steps wrote the checkpoint)' if i == 0 else ''} "
              f"({both_s:.1f} s)", flush=True)


# phase 13a: the OS I-S baseline (`core.ozaki1`) on the int8 tensor cores
# (`torch._int_mm`): card == cpu bitwise at OZAKI1_CASES (ragged, so the
# padding runs; m = 12 below `_int_mm`'s 17) for S in OZAKI1_SLICES, float64
# and complex128; then complex128 OZAKI1_MAIN^3 at S = 9 against
# torch.matmul within OZAKI1_RTOL (tests/test_core_gemm.py's bound), timed,
# its int8 products counted (3 real emulations x S(S+1)/2)
OZAKI1_CASES = ((250, 383, 517), (12, 64, 64))
OZAKI1_SLICES = (5, 9)
OZAKI1_MAIN, OZAKI1_MAIN_S, OZAKI1_RTOL = 4096, 9, 1e-11
# phase 13b: the dry run (`launch.dryrun`) in subprocesses, started after
# phase 12's timed cases, beside 12c (they use the host alone and take ~50
# s; 12c's seconds are taken beside them) and read in phase 13:
# the CLI for these archs' train_4k on 16 x 16, and this script's
# --dry-run-task for phase 12a's (2, 2, 1) step and for phase 9b's
# one-process step (`dry_run`); the predicted peak of 9b's step within
# DRYRUN_PEAK_RATIO of the card's
DRYRUN_CLI_ARCHS = ("mamba2-130m", "qwen2.5-32b")
DRYRUN_PEAK_RATIO = (0.75, 1.5)
DRYRUN_TIMEOUT = 600


def ozaki1_phase(rng, dev, zgemm_ms):
    """Phase 13a (see OZAKI1_CASES).  `zgemm_ms`: phase 3b's kernel and
    cuBLAS zgemm times at MAIN^3, printed beside."""
    from repro_torch.core import ozaki1

    for m, k, n in OZAKI1_CASES:
        for dtype in (np.float64, np.complex128):
            a, b = phi_matrix(rng, (m, k), PHI, dtype), phi_matrix(rng, (k, n), PHI, dtype)
            fn = ozaki1.ozaki1_cgemm if np.iscomplexobj(a) else ozaki1.ozaki1_gemm
            for s in OZAKI1_SLICES:
                before = ozaki1.int8_product.int_mm_calls
                got = fn(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), s)
                want = fn(a, b, s, device="cpu")
                calls = ozaki1.int8_product.int_mm_calls - before
                expect = (3 if np.iscomplexobj(a) else 1) * ozaki1.int8_gemm_count(s)
                what = f"13a ozaki1 {np.dtype(dtype).name} ({m}, {k}, {n}) S={s}"
                if not same_bits(got.cpu(), want):
                    raise AssertionError(f"{what}: card != cpu, {first_difference(got.cpu(), want)}")
                if calls != expect:
                    raise AssertionError(f"{what}: {calls} torch._int_mm calls, expected {expect}")
        print(f"  13a ozaki1 ({m}, {k}, {n}), S = {OZAKI1_SLICES}, float64 and complex128: card == cpu bitwise, "
              f"one torch._int_mm a cross product", flush=True)
    size, s = OZAKI1_MAIN, OZAKI1_MAIN_S
    a = torch.from_numpy(phi_matrix(rng, (size, size), PHI, np.complex128)).to(dev)
    b = torch.from_numpy(phi_matrix(rng, (size, size), PHI, np.complex128)).to(dev)
    ozaki1.ozaki1_cgemm(a, b, s)  # warm-up
    before = ozaki1.int8_product.int_mm_calls
    y, ms = timed_calls(lambda: ozaki1.ozaki1_cgemm(a, b, s), 3)
    products = (ozaki1.int8_product.int_mm_calls - before) // 3
    rel = rel_error(y, a, b)
    expect = 3 * ozaki1.int8_gemm_count(s)
    print(f"  13a ozaki1_cgemm complex128 {size}^3, S = {s}: {ms:.3f} ms ({8 * size**3 / ms / 1e9:.2f} TFLOPS; "
          f"phase 3b's kernel zgemm {zgemm_ms[0]:.3f} ms, cuBLAS zgemm {zgemm_ms[1]:.3f} ms), rel_err {rel:.3e} "
          f"(bound {OZAKI1_RTOL}), {products} int8 products on torch._int_mm (3 x {ozaki1.int8_gemm_count(s)})",
          flush=True)
    if products != expect or not rel <= OZAKI1_RTOL:
        raise AssertionError(f"13a ozaki1_cgemm {size}^3: {products} products (expected {expect}), "
                             f"relative error {rel} (bound {OZAKI1_RTOL})")
    return {"ms": ms, "rel_err": rel, "products": products}


def start_dryruns(tmp):
    """13b's subprocesses, all started at once: {name: process}.  They use
    the host alone, at a lower priority than phase 12c's processes."""
    src = str(pathlib.Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    start = functools.partial(subprocess.Popen, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              preexec_fn=functools.partial(os.nice, 10))
    jobs = {}
    for arch in DRYRUN_CLI_ARCHS:
        jobs[arch] = start([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", "train_4k",
                            "--out", str(tmp / "cli")])
    for task in ("mesh", "one"):
        jobs[task] = start([sys.executable, str(pathlib.Path(__file__).resolve()), "--dry-run-task", task, str(tmp)])
    return jobs


def dry_run_task(task, tmp) -> int:
    """Card-less side of 13b (this script started with --dry-run-task):
    the dry run of phase 12a's mamba2-130m `kernel` step on (2, 2, 1)
    (`task` "mesh") or of phase 9b's one-process step ("one"), on meta
    tensors, written to TMP/dryrun_<task>.json."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch import GemmPolicy
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.optim import AdamWConfig, cosine_warmup

    cfg, data = mesh_train_model("mamba2", GemmPolicy)
    spec = ShapeSpec(f"train_b{data.global_batch}_s{data.seq_len}", data.seq_len, data.global_batch, "train")
    opt = AdamWConfig(**TRAIN_OPT)
    if task == "mesh":
        out = dry_run(cfg, spec, ((2, 2, 1), SHARD_NAMES), opt_cfg=opt, donate=True)
    else:
        out = dry_run(cfg, spec, None, opt_cfg=opt, schedule=cosine_warmup(TRAIN_WARMUP, TRAIN_STEPS), donate=True)
    (pathlib.Path(tmp) / f"dryrun_{task}.json").write_text(json.dumps(out))
    return 0


def finish_dryrun(name, proc, t0):
    """A 13b subprocess's output, once it exited 0 (else the phase fails)."""
    out, err = proc.communicate(timeout=max(1.0, t0 + DRYRUN_TIMEOUT - time.perf_counter()))
    if proc.returncode != 0:
        raise AssertionError(f"13b {name}: exited {proc.returncode}:\n{out[-6000:]}\n{err[-4000:]}")
    return out


def measured_step(dev, GemmPolicy, kernels):
    """Phase 9b's one-process `kernel` step on the card, after a warm-up
    step: its launches by kernel and its peak memory, the step's own (the
    max allocated during it less what was allocated before its state was
    made, so its params, optimizer state and batch count and nothing of
    the earlier phases)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, cosine_warmup
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_state

    cfg, data = mesh_train_model("mamba2", GemmPolicy)
    model, src, opt = Model(cfg), SyntheticLM(data), AdamWConfig(**TRAIN_OPT)
    step = make_train_step(model, opt, cosine_warmup(TRAIN_WARMUP, TRAIN_STEPS))[0]
    gc.collect()  # no earlier phase's garbage freed during the step
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params, state = init_state(model, opt, torch.Generator().manual_seed(0), dev)
    batch = [{k: torch.from_numpy(v).to(dev) for k, v in src.batch(i).items()} for i in range(2)]
    params, state, met = step(params, state, batch[0])
    del met
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    params, state, met = step(params, state, batch[1])
    torch.cuda.synchronize()
    counts = nonzero_counts(kernels)
    peak = torch.cuda.max_memory_allocated() - base
    del params, state, met, batch
    torch.cuda.empty_cache()
    return counts, peak


def dryrun_phase(jobs, tmp, dev, GemmPolicy, kernels, mesh_lines, t0):
    """Phase 13b: read the dry-run subprocesses; hold the predicted
    collectives of phase 12a's (2, 2, 1) step to rank 0's log there, the
    predicted launches of 9b's step to the card's count of that step, and
    the predicted peak (arguments + temp) within DRYRUN_PEAK_RATIO of the
    card's."""
    counts, peak = measured_step(dev, GemmPolicy, kernels)
    check_train_launches(counts, train_expect("kernel"), TRAIN_LINEARS, 1, "13b the card's 9b step")
    for arch in DRYRUN_CLI_ARCHS:
        out = finish_dryrun(arch, jobs[arch], t0)
        line = [x for x in out.splitlines() if x.startswith("[ok]")]
        rec = json.loads((tmp / "cli" / f"{arch}__train_4k__pod16x16.json").read_text())
        mem = rec["memory_analysis"]
        if len(line) != 1 or rec["status"] != "ok" or "fits" not in rec:
            raise AssertionError(f"13b the dry-run CLI on {arch}: {out[-4000:]}")
        print(f"  13b python -m repro_torch.launch.dryrun --arch {arch} --shape train_4k (a dry run on meta tensors, "
              f"rank 0 of a fake world of 256): {line[0].removeprefix('[ok]').strip()}", flush=True)
        print(f"      record: args {mem['argument_size_in_bytes']} B, temp {mem['temp_size_in_bytes']} B, output "
              f"{mem['output_size_in_bytes']} B, fits {rec['fits']} (80 GiB), flops/dev {rec['flops_per_device']:.4e}, "
              f"broadcast {rec['collectives']['broadcast']} B in {rec['collectives']['counts']['broadcast']} ops, "
              f"build {rec['lower_s']} s, trace {rec['compile_s']} s", flush=True)
    pred = {}
    for task in ("mesh", "one"):
        finish_dryrun(f"--dry-run-task {task}", jobs[task], t0)
        pred[task] = json.loads((tmp / f"dryrun_{task}.json").read_text())

    (logged,) = [x for x in mesh_lines if x["model"] == "mamba2" and tuple(x["mesh"]) == (2, 2, 1)]
    predicted = pred["mesh"]["collectives"]
    if predicted != logged["collectives"]:
        raise AssertionError(f"13b collectives of 12a's (2, 2, 1) step: predicted {predicted}, rank 0 logged "
                             f"{logged['collectives']}")
    print(f"  13b mamba2-130m kernel step on (2, 2, 1), B {TRAIN_B} x S {TRAIN_S}: predicted collectives of rank 0 "
          f"(counts {predicted['counts']}, bytes {predicted['total']}) == phase 12a rank 0's CollectiveLog (its last "
          f"step); trace {pred['mesh']['compile_s']} s", flush=True)

    one = pred["one"]
    if one["launches"] != counts:
        raise AssertionError(f"13b 9b's step: predicted launches {one['launches']}, the card counted {counts}")
    mem = one["memory_analysis"]
    predicted_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    ratio = predicted_peak / peak
    print(f"  13b mamba2-130m kernel one-process step (9b's): predicted launches {one['launches']} == the card's "
          f"count; predicted peak {predicted_peak / 2**30:.3f} GiB (args {mem['argument_size_in_bytes'] / 2**30:.3f} "
          f"+ temp {mem['temp_size_in_bytes'] / 2**30:.3f}) against torch.cuda.max_memory_allocated "
          f"{peak / 2**30:.3f} GiB: ratio {ratio:.3f} (held within {DRYRUN_PEAK_RATIO}); predicted flops/dev "
          f"{one['flops_per_device']:.4e}, int8 ops {one['kernel_ops_per_device']['int8']:.4e}", flush=True)
    if not DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1]:
        raise AssertionError(f"13b 9b's step: predicted peak {predicted_peak} B against the card's {peak} B "
                             f"(ratio {ratio:.3f})")
    return {"peak_ratio": ratio, "predicted_peak": predicted_peak, "peak": peak}


def rank_main(tasks, tmp, device_type, argv) -> int:
    """A rank of phase 10 (this script started with --rank-task)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    tmp = pathlib.Path(tmp)
    rank = int(os.environ["RANK"])
    if tasks.startswith("cli_"):  # the CLI joins the launcher's group itself
        rc, rec = cli_mesh_record(argv) if tasks == "cli_mesh_train" else cli_record(tasks[4:], argv)
        (tmp / f"{tasks}.rank{rank}.json").write_text(json.dumps(rec))
        return rc
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world

    dev, _ = init_world(torch.device(device_type))
    try:
        for task in tasks.split(","):
            out = {"gemms": rank_gemms, "serving": rank_serving, "mesh_train": rank_mesh_train,
                   "compress": rank_compress, "pipeline": rank_pipeline}[task](dev, tmp)
            (tmp / f"{task}.rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank-task"]:
        return rank_main(*sys.argv[2:5], sys.argv[5:])
    if sys.argv[1:2] == ["--dry-run-task"]:
        return dry_run_task(*sys.argv[2:4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import repro_torch.kernels as kernels
    from repro_torch import GemmPolicy, linalg
    from repro_torch.kernels import build
    from repro_torch.kernels.common import COMPILED_TILES

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"card: {card_line()}", flush=True)

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"  built {len(logs)} kernel sources in {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = ptxas_tiles(logs)
    for name, log in logs.items():
        if WGMMA_SERIALIZED in log:
            raise AssertionError(f"{name}: ptxas serialized wgmma instructions:\n{log}")
    for label, (regs, spill, count) in ptxas["flash_attention"].items():
        if label.startswith("bf16") and spill:
            raise AssertionError(f"flash_attention {label}: {spill} bytes of spill stores")
    for name, slot in NO_SPILL_AT_DEFAULT.items():
        default = "tile " + tile_label(COMPILED_TILES[slot][0])
        if ptxas[name][default][1]:
            raise AssertionError(f"{name} {default}: {ptxas[name][default][1]} bytes of spill stores")
    for name, log in logs.items():
        if name in ptxas:
            for label, (regs, spill, count) in ptxas[name].items():
                print(f"  {name} {label}: at most {regs} registers and {spill} bytes of spill "
                      f"stores over its {count} compiled variants", flush=True)
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products in full f32
    print("phase 2: kernels against their plain versions, bitwise (attention within its tolerance)", flush=True)
    checks = KernelChecks(rng, dev)
    checks.chain(RAGGED, np.float32, 8, timed=False)
    checks.chain(RAGGED, np.complex64, 14, timed=False)
    checks.chain((MAIN, MAIN, MAIN), np.float32, 8, timed=True)
    checks.chain((MAIN, MAIN, MAIN), np.complex128, 14, timed=True)
    checks.tiles()
    checks.load_paths("fp8_karatsuba")
    checks.load_paths("fp8_mod_gemm")
    checks.load_paths("karatsuba_fused")
    checks.load_paths("int8_mod_gemm")
    checks.residue_cast_cases()
    checks.garner_cases()
    checks.karatsuba_worst_case()
    checks.int8_worst_case()
    checks.clusters()
    checks.megakernels((MAIN, MAIN, MAIN), np.float32, 8, chunk_limit=1 << 17, timed=True)
    checks.megakernels((MAIN, MAIN, MAIN), np.complex128, 14, chunk_limit=1 << 17, timed=True)
    checks.fp8_worst_case()
    checks.launch_copy()
    checks.attention()
    torch.cuda.synchronize()
    print(f"  all {len(KERNELS)} kernels agree with their plain versions", flush=True)

    print(f"phase 3a: {SMALL}^3 end to end, card vs device='cpu'", flush=True)
    end_to_end_cpu_parity(rng, dev, GemmPolicy, linalg)

    print("phase 3b: kernel main path", flush=True)
    counts, results = main_path(rng, dev, GemmPolicy, linalg, kernels)
    tma = {"karatsuba_fused": kernels.karatsuba_fused.karatsuba_mod_gemm_batched.tma_launches,
           "int8_mod_gemm": kernels.int8_mod_gemm.int8_mod_gemm_batched.tma_launches}
    zgemm_ms = next((r["kernel_ms"], r["native_ms"]) for r in results if r["routine"] == "zgemm")
    print(f"  kernel main-path launches: {counts} (by TMA: karatsuba_fused {tma['karatsuba_fused']}, "
          f"int8_mod_gemm {tma['int8_mod_gemm']})", flush=True)

    print("phase 3c: fused main path", flush=True)
    fused_counts = fused_main_path(results, GemmPolicy, linalg, kernels)
    print(f"  fused main-path launches: {fused_counts}", flush=True)
    launch_bound_sgemm(rng, dev, GemmPolicy, linalg)

    print("phase 3d: fp8 main path", flush=True)
    fp8_counts = fp8_main_path(results, GemmPolicy, linalg, kernels)
    tma["fp8_karatsuba"] = kernels.fp8_mod_gemm.fp8_karatsuba_mod_gemm_batched.tma_launches
    tma["fp8_mod_gemm"] = kernels.fp8_mod_gemm.fp8_mod_gemm_batched.tma_launches
    print(f"  fp8 main-path launches: {fp8_counts} (by TMA: fp8_karatsuba {tma['fp8_karatsuba']}, "
          f"fp8_mod_gemm {tma['fp8_mod_gemm']})", flush=True)
    results = [r for r in results if r["size"] == MAIN]
    torch.cuda.empty_cache()

    print("phase 3e: reference execution", flush=True)
    reference_main_path(results, GemmPolicy, linalg, kernels)
    torch.cuda.empty_cache()

    print("phase 3f: per-modulus execution", flush=True)
    per_modulus_counts = per_modulus_path(rng, dev, results, GemmPolicy, linalg, kernels)
    print(f"  per-modulus main-path launches: {per_modulus_counts}", flush=True)

    print("phase 3g: backward", flush=True)
    backward_path(rng, dev, results, GemmPolicy, linalg, kernels)
    torch.cuda.empty_cache()

    print("phase 4: prepared serving", flush=True)
    serving(rng, dev, GemmPolicy, linalg, kernels)

    print("phase 5: tuning", flush=True)
    tune_counts = tuning(results, GemmPolicy, linalg, kernels)

    print("phase 6: attention prefill", flush=True)
    attention_counts = attention_prefill(checks.full_attention, kernels)

    del results
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    print("phase 7a: model serving, reduced configs, card vs cpu", flush=True)
    model_serving_reduced(rng, dev, GemmPolicy)
    print(f"  phase 7a took {time.perf_counter() - t7:.1f} s", flush=True)
    print("phase 7b: model serving, starcoder2-3b as published", flush=True)
    serve_counts = model_serving_full(rng, dev, GemmPolicy, kernels)
    print(f"  phase 7b launches: {serve_counts}", flush=True)
    print("phase 7c: serve CLI", flush=True)
    serve_cli()
    print(f"  phase 7 took {time.perf_counter() - t7:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    print("phase 8: the SSD, RG-LRU and MoE archs at full width", flush=True)
    blocks_counts = model_serving_blocks(rng, dev, GemmPolicy, kernels)
    print(f"  phase 8 launches: {blocks_counts}", flush=True)
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    print("phase 9a: training, reduced configs, card vs cpu", flush=True)
    train_counts = training_reduced(rng, dev, GemmPolicy, kernels)
    print(f"  phase 9a took {time.perf_counter() - t9:.1f} s", flush=True)
    print(f"phase 9b: training {TRAIN_ARCH} as published", flush=True)
    add_counts(train_counts, training_full(rng, dev, GemmPolicy, kernels))
    torch.cuda.empty_cache()
    print(f"phase 9c: training {TRAIN_WIDE_ARCH} at full width", flush=True)
    add_counts(train_counts, training_wide(rng, dev, GemmPolicy, kernels))
    torch.cuda.empty_cache()
    print("phase 9d: train CLI", flush=True)
    train_cli()
    print(f"  phase 9 launches: {train_counts}", flush=True)
    print(f"  phase 9 took {time.perf_counter() - t9:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    shard_tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    try:
        print("phase 10a: sharded GEMMs, ranks on the card (1 over NCCL, 2 and 4 over gloo); 10b: "
              f"starcoder2-3b at full width, {SHARD_SERVE_LAYERS} layers, served by the 2 ranks", flush=True)
        shard_counts = sharded_phase(dev, GemmPolicy, linalg, shard_tmp)
        print("phase 10c: the serve and train CLIs under torch.distributed.run, 2 ranks", flush=True)
        sharded_clis(dev, shard_tmp)
    finally:
        import shutil

        shutil.rmtree(shard_tmp, ignore_errors=True)
    shard_counts = {k: v for k, v in shard_counts.items() if v}
    print(f"  phase 10 launches (rank 0): {shard_counts}", flush=True)
    print(f"  phase 10 took {time.perf_counter() - t10:.1f} s", flush=True)
    torch.cuda.empty_cache()
    print("phase 11: the static analysis (11a the smoke matrix, 11b k = 2^17 + 5, 11c launches by torch.profiler, "
          "11d a negative control)", flush=True)
    analysis_phase(dev, GemmPolicy, linalg)
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    mesh_tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    dry_tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    jobs = {}
    try:
        print("phase 12a/b/d: the parameter-sharded training mesh, ranks on the card over gloo (2 and 4); 12d "
              "compression and the pipeline", flush=True)
        mesh_counts, mesh_lines = mesh_training(dev, GemmPolicy, mesh_tmp)
        print("phase 13b's dry runs started in subprocesses (they use the host alone, beside 12c)", flush=True)
        jobs, t_dry = start_dryruns(dry_tmp), time.perf_counter()
        print("phase 12c: the train CLI with --mesh under torch.distributed.run, 2 ranks, and its resume on "
              "another mesh", flush=True)
        mesh_train_cli(dev, mesh_tmp)
        print(f"  phase 12 launches (rank 0): {mesh_counts}", flush=True)
        print(f"  phase 12 took {time.perf_counter() - t12:.1f} s", flush=True)
        torch.cuda.empty_cache()
        t13 = time.perf_counter()
        print("phase 13a: the OS I-S baseline (core.ozaki1) on torch._int_mm", flush=True)
        ozaki1_phase(rng, dev, zgemm_ms)
        torch.cuda.empty_cache()
        print("phase 13b: the dry run (launch.dryrun) against phase 12's collectives and phase 9b's step", flush=True)
        dryrun_phase(jobs, dry_tmp, dev, GemmPolicy, kernels, mesh_lines, t_dry)
    finally:
        for proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        import shutil

        shutil.rmtree(mesh_tmp, ignore_errors=True)
        shutil.rmtree(dry_tmp, ignore_errors=True)
    print(f"  phase 13 took {time.perf_counter() - t13:.1f} s", flush=True)

    launches = {"kernel": counts, "fused": fused_counts, "fp8": fp8_counts, "tune": tune_counts,
                "attention": attention_counts}
    record = []
    for name, replaces in KERNELS.items():
        r = checks.record[name]
        record.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[PATH_OF[name]][name],
            "serve_launches": serve_counts.get(name, 0),
            "blocks_serve_launches": blocks_counts.get(name, 0),
            "train_launches": train_counts.get(name, 0),
            "sharded_launches": shard_counts.get(name, 0),
            "tma_launches": tma.get(name),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            "wall_ms": r.get("wall_ms"),
            "events_ms": r.get("events_ms"),
            "tiles_ms": r.get("tiles_ms"),
            "ptxas": ptxas.get(name),
            "int_mm_ms": r.get("int_mm_ms"),
            "scaled_mm_ms": r.get("scaled_mm_ms"),
            "kernel_path_ms": r.get("kernel_path_ms"),
            "cols_ms": r.get("cols_ms"),
            "global_ms": r.get("global_ms"),
            "clusters": r.get("clusters"),
            "f32": r.get("f32"),
            "max_abs_err_by_type": r.get("max_abs_err_by_type"),
            "row_err": r.get("row_err"),
            "control_row_err": r.get("control_row_err"),
            "library_max_abs_diff": r.get("library_max_abs_diff"),
            "shape": r["shape"],
        })
    print(json.dumps({"kernels": record}), flush=True)
    print(card_line(), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
