"""Smoke run of the PyTorch port's paths on one NVIDIA GPU: GPT-2 serving (float
and int8) and training (torch.autograd; two-pass and fused flash backward),
chunked attention through ``flash_block``, BERT-base masked-LM training
(padding mask and ``attention_lengths``), its int8 ``QuantLinear`` forward,
the conv path (ResNet-18 training) on the lightgrad tape, the LLaMA
family (Mistral-7B and Gemma-2B serving, and training on the tape), and
the GPT-NeoX / Pythia family (Pythia-1B and -2.8B
training on the tape through the fused flash backward; Pythia-1B
``generate``), scanned stacks with remat, checkpoint resume, LoRA and the
tokenizers / HF files, the vision families (ViT-B/16 training, DDPM
training and sampling), the numpy oracle against the card, and the last
families: T5-base and flan-T5-base on the tape (training, cached, beam and
compiled decoding) and GPT-2 small with mixture-of-experts blocks, the
parallel layer at world size 1, the JAX package's examples on the port
(lightgrad_tpu_torch/examples/), and the step compiler (``jit``: tape
steps captured into CUDA graphs and replayed).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles lightgrad_tpu_torch/csrc/*.cu for sm_90a;
  3. kernels: each hand-written kernel (CUDA C++ or Triton) against its
     plain PyTorch version on the card, at its path's shapes, in float32 and
     bfloat16 -- max abs / rel error against a stated tolerance, CUDA-event
     times of both, of one PyTorch call computing the same function where
     there is one, and the kernel's bound (the least time of its bytes at
     3.35 TB/s or its operations at the dtype's peak); the stack kernel's
     six int8 instantiations on GPT-2 small's own quantized weights; the
     conv kernels of both routes (tensor cores: every one of ResNet-18's 11
     convolutions at batch 32 and ResNet-20's 6 wider ones on the digits
     path at batch 128; CUDA cores: narrow channels) and the
     grouped, dilated, 1-D and 3-D cases, each gradient repeated bit for
     bit, timed by CUDA graph at layer 1's shape (the CUDA-core route at
     ResNet-20's 16-channel layer) beside cuDNN, the channels-last staging
     against its plain version; LayerNorm and flash_block's backward also
     by CUDA graph; the flash
     kernels with per-row lengths at BERT-base's attention shape (8 x 12
     heads of 128 x 64, lengths 64-128; G 1 and 2, causal and not), the
     fused flash backward at GPT-2's 96 x 1024 x 64 (causal, bit for bit on
     a rerun) and
     ``flash_block`` at the chunk shape 96 x 256 x 64 with a nonzero lse
     cotangent; the LLaMA family's attention: the sliding window at a
     Mistral-7B layer (32 x 8192 x 128, 8 KV heads, window 4096), head dim
     256 at Gemma-2B's prefill and training shapes, head dim 32 at the char
     example's, head dims 8, 16, 80 and 200 and windows of S or more for
     correctness, and decode attention at Gemma's (1, 8, 256) and
     Mistral's (8, 4, 128) decode shapes, split over blocks (the record
     carries n_split, planned from the window, never the position), its
     error scaled by the reference's rms past one ulp (one split's range
     alone must fail), its merge kernel timed alone on the plain split's
     partials, both timed by CUDA graph beside SDPA (plain versions one KV
     group at a time; the library call is SDPA with ``enable_gqa``); the
     batched decode attention (LLaMA's ``step_batch``: 4 slots at their
     own device positions over a stacked cache's strided views, one
     launch) at both engines' shapes against its plain version and one
     reference a slot, captured in a CUDA graph and replayed after the
     positions move; the bf16 flash forward (tensor cores) everywhere
     within FWD_TOL of the reference's rms past one ulp, with zeros, no
     causal mask, no band and a last K tile dropped failing it; the
     forward at BERT-base's 96 x 128 x 64 without a mask (the call shape
     of the TPU kernel's two-heads-a-step variant); the fused flash backward at
     Pythia-1B's attention (2 x 8 heads of 2048 x 256), Pythia-2.8B's (32
     heads of 2048 x 80) and head dim 32, causal, timed beside the two
     passes and SDPA's backward, and at head dims 200 and 80 without the
     causal mask -- at every shape the fused kernel against its plain
     version and the two passes against theirs, within one ulp of each
     element plus the tolerance times the reference's rms (in bf16 the
     plain versions round p and ds to bf16 as the TPU kernels and the
     tensor-core kernels do), its bound from the function's own bytes and
     products; the backward's kernels at GPT-2's, Pythia's, the Mistral-7B
     layer's and Gemma-2B's training shapes also by CUDA graph, and SDPA's
     backward by CUDA graph (forward and backward less the forward); the
     tape's matmul (``wgmma`` tensor cores: bf16 one pass, f32 three tf32
     passes) at BERT-base's products and by CUDA graph at four shapes
     (MATMUL_SHAPES: row 3's decoder, Mistral-7B's MLP up-projection and
     its weight gradient, Pythia-1B's QKV) with the f32 bound at three tf32
     passes (TF32_OPS), and the f32 kernel against a float64 product within
     4x cuBLAS f32's error, a bar cuBLAS with TF32 on must fail; the f32
     flash backward passes (three tf32 passes on the tensor cores) with
     their bound at three tf32 passes, and at GPT-2's training shape
     against a float64 backward within KERNEL_TOL, a bar the same
     arithmetic with one tf32 pass a product must fail; the f32 flash
     forward (three tf32 passes too) at GPT-2's prefill shape against a
     float64 forward, a bar one tf32 pass must fail, and the f32 fused
     backward against its plain version evaluated in float64; the
     elementwise kernel at the main paths' classes (GELU, a bias, a
     per-channel operand and its expanded gradient, the padding mask, a
     Python scalar, a transposed weight gradient, a rotary slice, vocab-wide
     rows, a residual add, the one-hot compare) and softmax, by CUDA graph
     with L2 flushed (operand sets rotated through FLUSH_BYTES); any path
     that copies an elementwise operand fails the run;
  4. serving path, GPT-2 small at its published widths (vocab 50257, 1024
     positions, d 768, 12 layers, 12 heads; seeded random weights), once in
     float32 and once after ``model.to(torch.bfloat16)``: ``generate``,
     ``generate_batch``, an ``InferenceEngine`` over 32 ragged requests, and
     a teacher-forced check of prefill + cached steps (packed whole-stack
     kernel and unrolled branch) against a plain full-sequence forward;
     then the same under ``quantize_serving``, ``quantize_kv`` and both
     (int8 weights against a plain forward over the dequantized weights,
     the int8 cache's two branches against each other and its tokens
     against the float cache's), with the engine's peak memory and cache
     bytes; in bfloat16, one long-context ``generate`` (960-token prompt)
     with the float and the int8 cache, and ``generate`` against
     ``generate_device`` there (wall and device ms a token, idle share,
     kernels a token: records); in each dtype and quantization mode, the
     decoding module after the 960-token prompt: ``generate_device``
     (greedy: ``generate``'s tokens; sampled at temperature 0.9, top-k 50,
     top-p 0.9: repeats under its seed), ``generate_batch_device`` over 8
     ragged prompts (each row the single run's, or first differing at a
     near-tie of the reference's logits), beam search (beam 1 is greedy,
     beam 4 scores no worse), ``generate_speculative`` and
     ``generate_speculative_device`` with a 2-layer draft cut from the
     target (greedy tokens; the acceptance rate printed; the device loop's
     one host read a round counted), and an engine of sampled requests --
     every device loop and the engine under
     ``torch.cuda.set_sync_debug_mode("error")``, their counted transfers
     (prompt upload, readback, the speculative (n, done)) excepted;
  5. training path, the same model on 8 x 1024 random tokens: (a) float32
     with Adam, (b) as (a) with the fused flash backward
     (``set_flash_fused(True)``), (c) bfloat16 ``MixedPrecision`` with
     AdamW, (d) as (c) with the fused flash backward, 5 steps each on
     one batch -- the loss must be finite and fall, and step 1's gradients
     of every parameter must match a plain step (the ``_reference`` versions
     under torch autograd); then chunked attention, ring attention's math in
     one process: 96 x 1024 x 64 causal in 4 chunks of 256 rows through
     ``flash_block``, merged as ``_merge`` does, one backward with an lse
     term, against one full call, in float32 and bfloat16;
  6. the lightgrad tape, BERT-base at its published widths (HF
     bert-base-uncased: vocab 30522, hidden 768, 12 layers, 12 heads,
     intermediate 3072, 512 positions; seeded random weights) on 8 x 128
     tokens with a padding mask, masked-LM labels on 15% of the valid
     positions: BertForMaskedLM + loss.cross_entropy + AdamW, 5 steps on one
     batch -- the loss must be finite and fall, step 1's logits and every
     parameter's gradient must match a plain twin (the ``_reference``
     versions under torch autograd), and one unmasked step must take the
     flash kernels; then a fresh BERT-base with the same weights through
     ``attention_lengths`` (the flash kernels with per-row lengths), 5 steps
     on the same batch, held to the same twin (valid rows' logits, every
     gradient) and to the masked run's logits; then a fresh BERT-base after
     ``quantize_module``: one forward against the float model's logits
     (cosine) and one backward;
  7. (the gradient-descent example: phase 15);
  8. the conv path on the tape, float32: (a) ResNet-18 at its torchvision
     widths (7x7/s2 stem, 3x3/s2 max pool, stages of 64-512, 1000 classes;
     seeded random weights) on 32 x 3 x 224 x 224 random images, AdamW, 5
     steps on one batch -- the loss must be finite and fall, step 1's
     logits and every parameter's gradient must match a plain twin (the
     ``_reference`` versions under torch autograd, in f32 and f64), the
     BatchNorm running statistics must move and an eval forward be finite;
     (b) one ``narrow`` forward + backward at a device start under
     ``torch.cuda.set_sync_debug_mode("error")`` (the digits examples:
     phase 15);
  9. the LLaMA family at its published widths, seeded random weights:
     (a) serving in bfloat16, Mistral-7B (16 of 32 layers; 8192 positions,
     cut from 32768) with a 4500-token prompt and Gemma-2B (all 18 layers,
     W 8192) with a 1000-token prompt: ``generate``, ``generate_batch``,
     an engine of 4 slots over 8 ragged requests, a teacher-forced check of
     prefill + cached steps against a plain full-sequence forward, and
     Mistral's check in float32 at 4 layers; the decoding module: greedy
     ``generate_device`` (32 tokens: ``generate``'s) and
     ``generate_batch_device`` over the engine's first 4 prompts under sync
     debug mode "error", beam search at beam 2 on Gemma-2B, and
     ``generate`` against ``generate_device`` (wall and device ms a token,
     idle share, kernels a token); a profiled prefill, step and
     engine tick (``step_batch`` over 4 slots: its launches, ms a token,
     device idle share, one batched decode-attention launch a layer); (b)
     training on the tape,
     float32, AdamW, 5 steps on one batch at full width cut to 2 layers:
     Mistral-7B on 1 x 8192 tokens (window active), Gemma-2B on 2 x 1024
     (head dim 256), each with step 1's logits and gradients against a
     plain twin (the char example: phase 15);
 10. the GPT-NeoX / Pythia family at its published widths, seeded random
     weights, on the tape in float32 with ``set_flash_fused(True)``: (a)
     Pythia-1B (all 16 layers, head dim 256, rotary_pct 0.25, parallel
     residual; 1.01 B parameters) and Pythia-2.8B (2 of 32 layers, head
     dim 80) trained with AdamW, 5 steps on 2 x 2048 and 1 x 2048 tokens,
     step 1's logits and gradients against a plain twin, the fused kernel
     launched and the two passes not; (b) Pythia-1B greedy ``generate``,
     8 tokens after a 64-token prompt, each the argmax of the twin's
     logits on the same 2048-token window, its window forward compiled by
     ``jit``; then again (all replays) against the eager forward's tokens;
 11. the rest of training and of serving I/O: (a) GPT-2 small scanned
     (``scan_layers=True``) at the JAX bench's configuration (vocab 50304,
     16 x 1024, bf16 ``MixedPrecision`` Adam at lr 3e-4 under
     ``WarmupCosine``) with remat False, "dots" and "full": step 1's
     gradients against the unscanned model from the same weights and
     against each other, the losses against each other, tokens/s, peak
     memory and idle share of each; greedy ``generate_device`` of the
     scanned model equals the unscanned one's; (b) a bitwise resume from
     ``save_checkpoint`` / ``load_checkpoint``: GPT-2 small in f32 Adam
     and BERT-base on the tape (its encoder scanned, remat "dots") in f32
     AdamW; (c) LoRA at Mistral-7B's
     widths (2 layers, bf16, 1 x 8192): rank-8 adapters on q_proj /
     v_proj trained by AdamW under ``WarmupCosine`` -- the loss falls,
     only the adapters change, and ``merge_lora``'s forward equals the
     adapted one; (d) serving I/O: ``GPT2Tokenizer`` on merges learned
     from this docstring -> bf16 GPT-2 ``generate_device`` -> ``decode``;
     ``save_pretrained`` -> ``from_pretrained`` through a temporary
     ``LIGHTGRAD_CACHE`` with identical logits; ``BertTokenizer.synthetic()``
     -> a BERT-base masked-LM forward;
 12. the vision families and the oracle, on the tape: (a) ViT-B/16 at
     ``google/vit-base-patch16-224``'s widths (seeded random weights): the
     patch embedding's conv (16², stride 16, 3 input channels) on its route
     and the flash kernels at 12 heads of 197 x 64, unmasked, against their
     plain versions; float32 AdamW, 5 steps on 32 images, step 1's logits
     and gradients against a plain twin, the ``scan_layers=True`` model
     (remat "full") bit for bit the unscanned one at step 1, images/s,
     where a step's time goes, eval logits against the plain forward; one
     bf16 ``MixedPrecision`` step and the bf16 eval logits; (b) (DDPM:
     phase 15); (c) the oracle: a sweep of tape ops on the card
     against the numpy ``CpuTensor``, forward and gradients, and
     ``assert_gradcheck`` on the card;
 13. the last families, seeded random weights: (a) T5-base at
     ``google-t5/t5-base``'s widths (vocab 32128, d_model 768, d_kv 64,
     d_ff 3072, 12 + 12 layers, 12 heads, 32 buckets, max distance 128,
     relu, tied; dropout off) on the tape: the softmax kernel at its
     encoder scores (8 x 12 x 512 x 512, padding mask and bias) fwd and bwd
     in both dtypes against the plain versions, timed by CUDA graph with L2
     flushed beside torch's; 5 float32 Adafactor steps on 8 sources of 512
     (two padded) and 8 targets of 114, step 1's logits and every gradient
     against a plain twin, the loss falls, tokens/s, peak memory, where a
     step's time goes, the relative-bias scatter's device time; cached
     ``generate`` (4 x 512, one masked, 64 tokens: wall and device ms a
     token), ``use_cache=False`` for 8 tokens (the same), ``generate_compiled``
     (64 tokens, the eager ones), ``beam_generate`` at beam 4 and beam 1
     (greedy); one forward of the bf16-cast model (every softmax bf16,
     logits against the f32 twin); (b) flan-T5-base's gated-GELU FFN (2048)
     and untied head: one step against its twin, ``generate_compiled`` for
     16 tokens equal to eager; (c) GPT-MoE at GPT-2 small's widths with 8
     experts of 3072 in every block, top-2 at capacity factor 1.25: the
     matmul kernel at its expert product (8 x 2560 x 768 @ 8 x 768 x 3072)
     against the plain version, timed beside torch.matmul; f32 AdamW on 8
     x 1024 tokens, loss CE + 0.01 aux, 5 steps: step 1's logits, aux and
     gradients against the plain twin (``moe_reference``'s one-hot
     products on the model's expert choices), every layer's kept and
     dropped routings equal to the twin's, the loss falls, tokens/s, device
     ms and idle share, peak memory, the expert products' launches; one
     bf16 ``MixedPrecision`` step; one step of the Switch-style model
     (top-1, every other block);
 14. the parallel layer at world size 1 (NCCL): BERT-base under
     BERT_TP_RULES with ring attention, the ring's chunked merge, GPT-2
     small through 1F1B at pp 1, cached decode at tp 1, a sharded
     checkpoint;
 15. the JAX package's examples on the port, each through its own
     function at the JAX script's configuration and step counts, the
     steps compiled by ``jit`` where the JAX script compiles them (any
     cut for time in EXAMPLE_CUTS, logged): gradient descent, MNIST's MLP and
     CNN and ResNet-20 on synthetic digits (test accuracy), BERT's offline
     config, the char GPT, the char LLaMA in f32 and --amp, the T5
     reversal, DDPM (then, at its trained weights, the loss and every
     gradient against a plain twin, a profiled step, ``p_sample`` against
     the twin, ``sample_ddim`` repeated bit for bit under the EMA
     weights), the serving tour (speculative = greedy, 16 Linears
     quantized); each example's printed lines, rate and launches are
     logged and its loss must fall (examples/distributed.py needs 8 ranks:
     CPU tests only);
 16. the step compiler, ``lightgrad_tpu_torch.jit``: JIT_STEPS compiled
     steps against JIT_STEPS eager steps from one start (weights carried
     back by ``load_numpy_params``), bit for bit -- BERT-base's masked-LM
     step (phase 6's batch, f32 AdamW) with the padding mask and with
     ``attention_lengths``, bf16 ``MixedPrecision`` with an overflow forced
     at one step (the gate skips it and the scale backs off inside the
     graph), ResNet-18 at 32 x 224² (BatchNorm's buffers written back);
     dropout on BERT-base's logits (two replays draw other masks, the keep
     rate within 1%); a ``load_numpy_params`` after compiling records again
     and trains the loaded weights; a host read inside a step raises
     ``CaptureError``; for each model wall ms a step eager and compiled,
     device ms and idle share, the capture's seconds, both peaks and the
     launches of a replay (Pythia-1B's compiled recompute decode against
     its eager tokens runs in phase 10b, on that phase's model).
Every kernel of each path must be launched by that path (the decoding
module's paths included: each GPT-2 one its stack kernel, LLaMA's
generate_device decode attention and its merge, generate_batch_device the
batched decode attention), and every kernel of the package by some path.
The line before the last is a JSON object of per-kernel results; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

import contextlib
import ctypes
import importlib
import json
import os
import subprocess
import sys
import time
from math import prod

import numpy as np
import torch

# References on the card run in full float32: no TF32 in matmuls or convs.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# name -> (route, source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "attention_fwd": ("cuda", "lightgrad_tpu_torch/csrc/flash_fwd.cu",
                      "lightgrad_tpu/ops/attention.py:267"),
    "decode_attention": ("cuda", "lightgrad_tpu_torch/csrc/decode_attention.cu",
                         "lightgrad_tpu/ops/decode_attention.py:64"),
    "decode_attention_batch": ("cuda",
                               "lightgrad_tpu_torch/csrc/decode_attention.cu",
                               "lightgrad_tpu/ops/decode_attention.py:64"),
    # the second launch of #11 where it splits a head's keys
    "decode_attention_merge": ("cuda",
                               "lightgrad_tpu_torch/csrc/decode_attention.cu",
                               "lightgrad_tpu/ops/decode_attention.py:64"),
    "decode_stack": ("cuda", "lightgrad_tpu_torch/csrc/decode_stack.cu",
                     "lightgrad_tpu/ops/decode_stack.py:282"),
    "decode_stack_batch": ("cuda", "lightgrad_tpu_torch/csrc/decode_stack.cu",
                           "lightgrad_tpu/ops/decode_stack.py:423"),
    "decode_stack_int8": ("cuda", "lightgrad_tpu_torch/csrc/decode_stack.cu",
                          "lightgrad_tpu/ops/decode_stack.py:158"),
    "decode_stack_kvq": ("cuda", "lightgrad_tpu_torch/csrc/decode_stack.cu",
                         "lightgrad_tpu/ops/decode_stack.py:168"),
    "decode_stack_int8_kvq": ("cuda",
                              "lightgrad_tpu_torch/csrc/decode_stack.cu",
                              "lightgrad_tpu/ops/decode_stack.py:176"),
    "decode_stack_batch_int8": ("cuda",
                                "lightgrad_tpu_torch/csrc/decode_stack.cu",
                                "lightgrad_tpu/ops/decode_stack.py:202"),
    "decode_stack_batch_kvq": ("cuda",
                               "lightgrad_tpu_torch/csrc/decode_stack.cu",
                               "lightgrad_tpu/ops/decode_stack.py:210"),
    "decode_stack_batch_int8_kvq": ("cuda",
                                    "lightgrad_tpu_torch/csrc/decode_stack.cu",
                                    "lightgrad_tpu/ops/decode_stack.py:217"),
    "attention_bwd_dq": ("cuda", "lightgrad_tpu_torch/csrc/flash_bwd.cu",
                         "lightgrad_tpu/ops/attention.py:604"),
    "attention_bwd_dkv": ("cuda", "lightgrad_tpu_torch/csrc/flash_bwd.cu",
                          "lightgrad_tpu/ops/attention.py:636"),
    "attention_bwd_fused": ("cuda", "lightgrad_tpu_torch/csrc/flash_bwd.cu",
                            "lightgrad_tpu/ops/attention.py:516"),
    # the (out, lse) unit over the flash kernels of flash_fwd.cu and
    # flash_bwd.cu, with lse's cotangent as dcap - dlse
    "flash_block": ("cuda", "lightgrad_tpu_torch/ops/attention.py",
                    "lightgrad_tpu/ops/attention.py:884"),
    "layernorm_fwd": ("triton", "lightgrad_tpu_torch/ops/layernorm.py",
                      "lightgrad_tpu/ops/layernorm.py:54"),
    "layernorm_bwd": ("triton", "lightgrad_tpu_torch/ops/layernorm.py",
                      "lightgrad_tpu/ops/layernorm.py:85"),
    "elementwise": ("triton", "lightgrad_tpu_torch/ops/elementwise.py",
                    "lightgrad_tpu/ops/elementwise.py:67"),
    "reduce": ("triton", "lightgrad_tpu_torch/ops/reduce.py",
               "lightgrad_tpu/ops/reduce.py:49"),
    "matmul": ("cuda", "lightgrad_tpu_torch/csrc/matmul.cu",
               "lightgrad_tpu/ops/matmul.py:90"),
    "softmax_fwd": ("triton", "lightgrad_tpu_torch/ops/softmax.py",
                    "lightgrad_tpu/ops/softmax.py:38"),
    "softmax_bwd": ("triton", "lightgrad_tpu_torch/ops/softmax.py",
                    "lightgrad_tpu/ops/softmax.py:38"),
    # a grid dimension over groups takes the place of _group_matmul (:90);
    # the tensor-core route (conv_tc.cu) and the CUDA-core one (conv.cu)
    "conv_fwd": ("cuda", "lightgrad_tpu_torch/csrc/conv_tc.cu",
                 "lightgrad_tpu/ops/conv.py:107"),
    "conv_bwd_dx": ("cuda", "lightgrad_tpu_torch/csrc/conv_tc.cu",
                    "lightgrad_tpu/ops/conv.py:122"),
    "conv_bwd_dw": ("cuda", "lightgrad_tpu_torch/csrc/conv_tc.cu",
                    "lightgrad_tpu/ops/conv.py:122"),
    "conv_layout": ("cuda", "lightgrad_tpu_torch/csrc/conv_tc.cu",
                    "lightgrad_tpu/ops/conv.py:107"),
    "conv_fwd_simt": ("cuda", "lightgrad_tpu_torch/csrc/conv.cu",
                      "lightgrad_tpu/ops/conv.py:107"),
    "conv_bwd_dx_simt": ("cuda", "lightgrad_tpu_torch/csrc/conv.cu",
                         "lightgrad_tpu/ops/conv.py:122"),
    "conv_bwd_dw_simt": ("cuda", "lightgrad_tpu_torch/csrc/conv.cu",
                         "lightgrad_tpu/ops/conv.py:122"),
}
KERNEL_NOTES = {
    "decode_attention_batch": "decode attention's kernel with a slot axis: "
                              "B slots at their own device positions in one "
                              "launch, the call shape of the JAX package's "
                              "jax.vmap of the kernel under LLaMA's batched "
                              "step (lightgrad_tpu/models/llama.py:591); "
                              "timed at Mistral-7B's 4-slot engine shape",
    "decode_attention_merge": "decode attention's second launch where it "
                              "splits a KV head's keys over blocks: the "
                              "merge of the splits' partials; timed alone "
                              "on partials of the plain split arithmetic",
    "conv_layout": "the tensor-core conv route's staging (NCHW to "
                   "channels-last, the weight's reorders), the part of the "
                   "JAX package's patch matrix (_conv_fwd_impl) this route "
                   "keeps in device memory; timed on layer 1's x",
    "conv_fwd_simt": "the CUDA-core conv route for narrow channel counts "
                     "(ops/conv.py conv_route); timed at ResNet-20's "
                     "16-channel layer",
    "conv_bwd_dx_simt": "as conv_fwd_simt",
    "conv_bwd_dw_simt": "as conv_fwd_simt",
    "flash_block": "launches no kernel of its own: it counts one a direction "
                   "beside the flash kernels it launches, which count too; "
                   "its times are theirs through its wrappers",
}
SERVING_KERNELS = ("attention_fwd", "decode_attention", "decode_stack",
                   "decode_stack_batch")
# phase 4's decoding-module paths -> the stack kernel they run (the int8
# instantiation's suffix appended under quantization); each prefills
DEVICE_PATHS = {"generate_device": "decode_stack",
                "generate_batch_device": "decode_stack_batch",
                "beam_search": "decode_stack",
                "generate_speculative": "decode_stack",
                "generate_speculative_device": "decode_stack",
                "engine (sampled)": "decode_stack_batch"}
# quantization mode -> the stack kernel's instantiations its serving runs
INT8_MODES = {"quantize_serving": "_int8", "quantize_kv": "_kvq",
              "both": "_int8_kvq"}
TRAINING_KERNELS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv",
                    "layernorm_fwd", "layernorm_bwd")
# the masked BERT step; its unmasked step adds the flash kernels
BERT_KERNELS = ("elementwise", "reduce", "matmul", "softmax_fwd",
                "softmax_bwd", "layernorm_fwd", "layernorm_bwd")
FLASH_KERNELS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv")
# BERT's attention_lengths step: the flash kernels take the softmax's place
BERT_LENGTHS_KERNELS = ("elementwise", "reduce", "matmul", "layernorm_fwd",
                        "layernorm_bwd") + FLASH_KERNELS
FUSED_KERNELS = ("attention_fwd", "attention_bwd_fused", "layernorm_fwd",
                 "layernorm_bwd")
FLASH_BLOCK_KERNELS = ("flash_block",) + FLASH_KERNELS
TAPE_KERNELS = ("elementwise", "reduce", "matmul")
CONV_KERNELS = ("conv_fwd", "conv_bwd_dx", "conv_bwd_dw")
CONV_SIMT_KERNELS = ("conv_fwd_simt", "conv_bwd_dx_simt", "conv_bwd_dw_simt")
# ResNet-18 runs every conv on the tensor cores; the MNIST CNN every conv on
# the CUDA cores (Cin 1, 8; Cout 8, 16); ResNet-20 both (16 channels on the
# CUDA cores, 32 and 64 on the tensor cores)
CONV_PATH_KERNELS = CONV_KERNELS + ("conv_layout",) + TAPE_KERNELS
DIGITS_KERNELS = {"MNIST CNN": CONV_SIMT_KERNELS + TAPE_KERNELS,
                  "ResNet-20": CONV_PATH_KERNELS + CONV_SIMT_KERNELS}
# Kernel vs plain version, max |err| <= tol * max(1, max |reference|).
# float32: the same f32 math summed in another order (FFMA chains or three
# tf32 passes against cuBLAS/ATen reductions, no TF32).  bfloat16: bf16 inputs, f32 sums, one
# rounding of the output to bf16 (2^-8 relative) on either side.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The bf16 flash forward rounds P to bf16 before P V, as the TPU kernel
# does (p.astype(v.dtype)), so its outputs are held by check_ulp: error past
# one ulp of each element within FWD_TOL times the reference's rms.  SDPA's
# bf16 flash kernel rounds P the same way and errs as much at the LLaMA
# prefill shapes (3.6e-2 at Mistral-7B's band, 3.8e-2 at Gemma-2B's: the
# "library's" lines of phase 3, PERF.md §6).
FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-2}
# KV-cache decoding vs a plain full-sequence forward of the same model, and
# step 1's gradients (max |err| / max |reference| per parameter) vs a plain
# step.  float32: other summation order through 12 layers.  bfloat16: both
# paths round every product and LayerNorm to bf16, at different points.
PATH_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 5, 6e-4
CHUNKS = 4      # chunked attention: 4 chunks of 256 rows of a 1024 window
GPT2_SMALL = dict(vocab_size=50257, n_positions=1024, n_embd=768,
                  n_layer=12, n_head=12, layer_norm_epsilon=1e-5)
# phase 4's decoding on the device: the long-context prompt and the new
# tokens of a run, generate_batch_device's 8 ragged prompts, the beam
# width, and the speculative draft (GPT-2 small's widths, 2 of its 12
# layers) with its proposals a round
DEVICE_PROMPT, DEVICE_NEW = 960, 32
DEVICE_BATCH = (960, 700, 512, 300, 128, 64, 17, 5)
BEAM_WIDTH, DRAFT_LAYERS, SPEC_K = 4, 2, 4
# decode_rates: new tokens of the profiled runs (the wall runs take 32)
PROFILED_NEW = 8
# the sampled runs' (temperature, top_k, top_p)
SAMPLED = dict(temperature=0.9, top_k=50, top_p=0.9)
# HF bert-base-uncased config.json
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12)
BERT_BATCH, BERT_SEQ, BERT_STEPS, BERT_LR = 8, 128, 5, 1e-4
# torchvision resnet18 at ImageNet's 224 x 224, batch 32
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS, RESNET_LR = 32, 224, 5, 1e-3
# ResNet-18's 11 distinct convolutions at batch 32, inputs after padding:
# (name, x, w, stride)
RESNET18_CONVS = (
    ("stem 3->64 7x7/s2", (32, 3, 230, 230), (64, 3, 7, 7), 2),
    ("layer1 64->64 3x3", (32, 64, 58, 58), (64, 64, 3, 3), 1),
    ("layer2 64->128 3x3/s2", (32, 64, 58, 58), (128, 64, 3, 3), 2),
    ("layer2 128->128 3x3", (32, 128, 30, 30), (128, 128, 3, 3), 1),
    ("projection 64->128 1x1/s2", (32, 64, 56, 56), (128, 64, 1, 1), 2),
    ("layer3 128->256 3x3/s2", (32, 128, 30, 30), (256, 128, 3, 3), 2),
    ("layer3 256->256 3x3", (32, 256, 16, 16), (256, 256, 3, 3), 1),
    ("projection 128->256 1x1/s2", (32, 128, 28, 28), (256, 128, 1, 1), 2),
    ("layer4 256->512 3x3/s2", (32, 256, 16, 16), (512, 256, 3, 3), 2),
    ("layer4 512->512 3x3", (32, 512, 9, 9), (512, 512, 3, 3), 1),
    ("projection 256->512 1x1/s2", (32, 256, 14, 14), (512, 256, 1, 1), 2),
)
# (name, x, w, strides, dilation, groups): both routes off ResNet-18's path
CONV_ODD_CASES = (
    ("grouped g=4, dilated d=2", (4, 32, 21, 19), (64, 8, 3, 3), 1, 2, 4),
    ("grouped g=4, Cg 16", (4, 64, 21, 19), (128, 16, 3, 3), 1, 1, 4),
    ("1-D", (4, 16, 129), (32, 16, 5), 2, 1, 1),
    ("3-D", (2, 8, 9, 10, 11), (16, 8, 3, 3, 3), (1, 2, 2), 1, 1),
    ("3-D, 16 -> 32", (2, 16, 9, 10, 11), (32, 16, 3, 3, 3), (1, 2, 2), 1,
     1),
    ("MNIST conv1", (128, 1, 30, 30), (8, 1, 3, 3), 1, 1, 1),
    ("ResNet-20 stem 1->16", (128, 1, 30, 30), (16, 1, 3, 3), 1, 1, 1),
    ("ResNet-20 16->16", (128, 16, 30, 30), (16, 16, 3, 3), 1, 1, 1),
)
# the CUDA-core route's timed shape: ResNet-20's 16-channel layer on the
# digits path
SIMT_TIMED = CONV_ODD_CASES[-1]
# ResNet-20's convolutions on the tensor cores, as the digits path gives
# them (examples/resnet.py: batch 128, 28 x 28 digits), inputs after
# padding: (name, x, w, stride)
RESNET20_TC_CONVS = (
    ("ResNet-20 16->32 3x3/s2", (128, 16, 30, 30), (32, 16, 3, 3), 2),
    ("ResNet-20 projection 16->32 1x1/s2", (128, 16, 28, 28),
     (32, 16, 1, 1), 2),
    ("ResNet-20 32->32 3x3", (128, 32, 16, 16), (32, 32, 3, 3), 1),
    ("ResNet-20 32->64 3x3/s2", (128, 32, 16, 16), (64, 32, 3, 3), 2),
    ("ResNet-20 projection 32->64 1x1/s2", (128, 32, 14, 14),
     (64, 32, 1, 1), 2),
    ("ResNet-20 64->64 3x3", (128, 64, 9, 9), (64, 64, 3, 3), 1),
)
# phase 8b's narrow: examples/mnist.py's batch over 60,000 digits
MNIST_BATCH = 128
# HF mistralai/Mistral-7B-v0.1 config.json; max_position_embeddings cut
# from 32768 to 8192: the cache window and the prefill length
MISTRAL_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=8, max_position_embeddings=8192,
                  rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=4096,
                  tie_word_embeddings=False)
# HF google/gemma-2b config.json, no cut
GEMMA_2B = dict(vocab_size=256000, hidden_size=2048, intermediate_size=16384,
                num_hidden_layers=18, num_attention_heads=8,
                num_key_value_heads=1, head_dim=256,
                max_position_embeddings=8192, rms_norm_eps=1e-6,
                rope_theta=10000.0, hidden_act="gelu_pytorch_tanh",
                rms_offset=True, scale_embeddings=True,
                tie_word_embeddings=True)
# Mistral-7B's serving depth: 16 of its 32 layers (all 32 until the
# scanned-stack, checkpoint, LoRA and serving-I/O phases joined the run)
MISTRAL_SERVING_LAYERS = 16
# (name, config, generate's prompt length, generate_batch's prompts, the
# engine's prompts): Mistral's prompts run prefill and decode past its band
LLAMA_SERVING = (("Mistral-7B", MISTRAL_7B, 4500, (4500, 1000, 60),
                  (4600, 32, 700, 2100, 90, 4100, 300, 1500)),
                 ("Gemma-2B", GEMMA_2B, 1000, (1000, 300, 40),
                  (1200, 16, 500, 800, 64, 1000, 200, 640)))
# (name, config, batch, sequence): training at full width, 2 layers
LLAMA_TRAINING = (("Mistral-7B", MISTRAL_7B, 1, 8192),
                  ("Gemma-2B", GEMMA_2B, 2, 1024))
LLAMA_LR = 3e-4
LLAMA_SERVING_KERNELS = ("attention_fwd", "decode_attention",
                         "decode_attention_batch", "decode_attention_merge")
# phase 9a's decoding-module paths -> the kernels each must launch
LLAMA_DEVICE_PATHS = {
    "generate_device": ("attention_fwd", "decode_attention",
                        "decode_attention_merge"),
    "generate_batch_device": ("attention_fwd", "decode_attention_batch",
                              "decode_attention_merge"),
    "beam_search": ("attention_fwd", "decode_attention")}
# phase 9a's decoding on the device: new tokens of generate_device (and
# of the timed generate / generate_device runs), of generate_batch_device
# over the engine's first 4 prompts, and of Gemma-2B's beam search
LLAMA_DEVICE_NEW, LLAMA_BATCH_NEW, LLAMA_BEAM = 32, 8, (2, 16)
LLAMA_TRAIN_KERNELS = TAPE_KERNELS + FLASH_KERNELS
# HF EleutherAI/pythia-1b config.json (GPTNeoXForCausalLM; 1.01 B
# parameters), no cut
PYTHIA_1B = dict(vocab_size=50304, hidden_size=2048, intermediate_size=8192,
                 num_hidden_layers=16, num_attention_heads=8,
                 max_position_embeddings=2048, rotary_pct=0.25,
                 rotary_emb_base=10000.0, layer_norm_eps=1e-5,
                 use_parallel_residual=True)
# HF EleutherAI/pythia-2.8b config.json
PYTHIA_2P8B = dict(PYTHIA_1B, hidden_size=2560, intermediate_size=10240,
                   num_hidden_layers=32, num_attention_heads=32)
# (name, config, layers kept, batch, sequence): training at full width on
# the model's full context; Pythia-2.8B cut from 32 layers to 2
NEOX_TRAINING = (("Pythia-1B", PYTHIA_1B, 16, 2, 2048),
                 ("Pythia-2.8B", PYTHIA_2P8B, 2, 1, 2048))
NEOX_LR = 3e-4
# Pythia-1B generate: prompt tokens, new tokens (each a 2048-token forward)
NEOX_PROMPT, NEOX_NEW = 64, 8
NEOX_TRAIN_KERNELS = TAPE_KERNELS + ("attention_fwd", "attention_bwd_fused",
                                     "layernorm_fwd", "layernorm_bwd")
# a forward alone: no loss, so no row reduction
NEOX_GENERATE_KERNELS = ("elementwise", "matmul", "attention_fwd",
                         "layernorm_fwd")
# HF mistralai/Mixtral-8x7B-v0.1 config.json (46.7 B parameters at its 32
# layers, 93 GB in bf16: more than the card); cut to 8 layers (11.9 B) and
# W 4096 (from 32768): a 1000-token prompt and its 32 tokens fit either
MIXTRAL_8X7B = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=32768, rms_norm_eps=1e-5,
                    rope_theta=1e6, num_local_experts=8,
                    num_experts_per_tok=2, tie_word_embeddings=False)
MIXTRAL_CUT = dict(num_hidden_layers=8, max_position_embeddings=4096)
# phase 9d: generate's prompt and new tokens, generate_batch_device's 4
# ragged prompts, the engine's 8 requests on 4 slots
MIXTRAL_PROMPT, MIXTRAL_NEW = 1000, 32
MIXTRAL_BATCH = (1000, 300, 40, 700)
MIXTRAL_ENGINE = (1000, 16, 500, 800, 64, 900, 200, 640)
# phase 9e: the int8 modes of each model (Mixtral's experts stay float, so
# it runs the cache's modes), their new tokens and engine requests
LLAMA_INT8_MODES = {"Mistral-7B": ("quantize_serving", "quantize_kv",
                                   "both"),
                    "Gemma-2B": ("quantize_serving", "quantize_kv", "both"),
                    "Mixtral-8x7B": ("quantize_kv", "both")}
INT8_NEW, INT8_ENGINE = 16, 4
# phase 9f (i): Mixtral-8x7B at full width cut to 1 layer, 1 x 1024
# tokens, f32 AdamW then bf16 MixedPrecision AdamW; the loss adds the
# router's load-balancing loss at this weight
MIXTRAL_TRAIN = (1, 1024, 5)
MIXTRAL_AUX = 0.01
MOE_TRAIN_KERNELS = LLAMA_TRAIN_KERNELS + ("softmax_fwd", "softmax_bwd")
# phase 9d's paths -> the kernels each must launch
MIXTRAL_PATHS = {"generate": ("attention_fwd", "decode_attention"),
                 "generate_device": ("attention_fwd", "decode_attention"),
                 "generate_batch_device": ("attention_fwd",
                                           "decode_attention_batch"),
                 "engine": ("attention_fwd", "decode_attention_batch")}
# One H100 SXM (NVIDIA's data sheet, dense rates at 700 W): HBM bytes
# a second and dense peak operations a second by input type
# phase 11a: GPT-2 small scanned at the JAX bench's training configuration
# (bench.py:947-958, 1272: vocab 50304, 16 x 1024, bf16 MixedPrecision Adam
# at lr 3e-4), under WarmupCosine, in each remat mode; greedy
# generate_device of SCAN_NEW tokens against the unscanned model
SCAN_GPT2 = dict(GPT2_SMALL, vocab_size=50304)
SCAN_BATCH, SCAN_LR, SCAN_WARMUP, SCAN_TIMED, SCAN_NEW = 16, 3e-4, 2, 3, 16
SCAN_REMATS = (False, "dots", "full")
# phase 11b: the GPT-2 resume's batch (x 1024 tokens)
CKPT_BATCH = 2
# phase 11c: LoRA at Mistral-7B's widths, 2 layers, bf16, 1 x LORA_SEQ
LORA_RANK, LORA_LR, LORA_STEPS, LORA_SEQ = 8, 1e-2, 5, 8192
# phase 11d: merges learned for the smoke's GPT2Tokenizer, new tokens
IO_MERGES, IO_NEW = 400, 16
# phase 12a: ViT-B/16 (ViTConfig's defaults are google/vit-base-patch16-224)
VIT_CFG = {}
VIT_BATCH, VIT_STEPS, VIT_LR = 32, 5, 1e-4
VIT_KERNELS = TAPE_KERNELS + FLASH_KERNELS + (
    "layernorm_fwd", "layernorm_bwd", "conv_fwd", "conv_bwd_dw",
    "conv_layout")
# phase 15: DDPM's checks after the example's run: a batch of DDPM_BATCH
# for the twin and the profiled step, DDPM_SAMPLES images by DDIM_STEPS hops
DDPM_BATCH, DDPM_SAMPLES, DDIM_STEPS = 64, 16, 50
DDPM_KERNELS = TAPE_KERNELS + CONV_KERNELS + ("conv_layout",) \
    + CONV_SIMT_KERNELS
DDPM_SAMPLE_KERNELS = TAPE_KERNELS + ("conv_fwd", "conv_layout",
                                      "conv_fwd_simt")
# phase 12c: the oracle sweep and the gradchecks
ORACLE_KERNELS = TAPE_KERNELS + ("softmax_fwd", "softmax_bwd") \
    + CONV_KERNELS + ("conv_layout",) + CONV_SIMT_KERNELS
GRADCHECK_KERNELS = TAPE_KERNELS + ("softmax_fwd", "softmax_bwd",
                                    "conv_fwd_simt", "conv_bwd_dx_simt",
                                    "conv_bwd_dw_simt")
# phase 13a: T5-base at HF google-t5/t5-base's config (not cut); dropout
# off, so that the tape's step and its plain twin compute one function
T5_BASE = dict(vocab_size=32128, d_model=768, d_kv=64, d_ff=3072,
               num_layers=12, num_decoder_layers=12, num_heads=12,
               relative_attention_num_buckets=32,
               relative_attention_max_distance=128, feed_forward_proj="relu",
               tie_word_embeddings=True, dropout_rate=0.0)
# phase 13b: google/flan-t5-base's gated-GELU FFN (2048) and untied head
FLAN_T5_BASE = dict(T5_BASE, d_ff=2048, feed_forward_proj="gated-gelu",
                    tie_word_embeddings=False)
# T5's pre-training lengths: 8 sources of 512 (rows 1 and 5 padded to 384
# and 200), 8 targets of 114; Adafactor at lr 1e-3 without parameter
# scaling
T5_BATCH, T5_SRC, T5_TGT, T5_PADDED = 8, 512, 114, (384, 200)
T5_STEPS, T5_LR = 5, 1e-3
# serving: sources, new tokens (cached, compiled), uncached tokens, (beam
# size, tokens); flan-T5-base's compiled tokens
T5_SERVE, T5_NEW, T5_UNCACHED, T5_BEAM = 4, 64, 8, (4, 32)
T5_TRACED = 16      # tokens of the traced generate (device ms a token)
FLAN_COMPILED = 16
T5_KERNELS = TAPE_KERNELS + ("softmax_fwd", "softmax_bwd")
T5_DECODE_KERNELS = TAPE_KERNELS + ("softmax_fwd",)
# phase 13c: GPT-2 small's widths with 8 experts of 3072 in every block,
# top-2 at capacity factor 1.25 (GPTConfig's Mixtral-style option), f32
# AdamW on 8 x 1024 tokens, loss CE + 0.01 aux_loss; the Switch-style
# model: top-1 every other block
GPT_MOE = dict(GPT2_SMALL, n_experts=8, moe_k=2, moe_hidden=3072,
               moe_dispatch="topk", moe_capacity_factor=1.25)
GPT_SWITCH = dict(GPT_MOE, moe_dispatch="top1", moe_every=2)
MOE_STEPS, MOE_LR, MOE_AUX = 5, 3e-4, 0.01
GPT_MOE_KERNELS = TRAINING_KERNELS + ("matmul",)
# phase 15: the ported examples (lightgrad_tpu_torch/examples/) at the JAX
# scripts' own configurations and step counts (their functions' defaults),
# their steps compiled by jit as the JAX scripts' are; EXAMPLE_CUTS: the
# steps of an example cut for the run's time (none since the steps compile)
EXAMPLE_CUTS = {}
# the serving tour's GPT (4 blocks): quantize_module(min_features=64)
# converts the 4 Linears of each block, as the JAX tour's does
TOUR_QUANT_LAYERS = 16
# the digits examples' test accuracy over 2,000 synthetic digits: well
# above chance (0.1)
DIGITS_ACCURACY = 0.5
EXAMPLE_KERNELS = {
    "gradient descent": TAPE_KERNELS,
    "MNIST MLP": TAPE_KERNELS,
    "MNIST CNN": DIGITS_KERNELS["MNIST CNN"],
    "ResNet-20": DIGITS_KERNELS["ResNet-20"],
    "BERT masked LM": ("elementwise", "matmul", "layernorm_fwd",
                       "attention_fwd"),
    "char GPT": TRAINING_KERNELS + ("decode_attention",),
    "char LLaMA": LLAMA_TRAIN_KERNELS + ("decode_attention",),
    "char LLaMA (--amp)": LLAMA_TRAIN_KERNELS + ("decode_attention",),
    "T5 reversal": T5_KERNELS,
    "DDPM": DDPM_KERNELS,
    "serving tour": ("attention_fwd", "decode_attention"),
}
HBM_BPS = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# the tf32 tensor-core rate: the f32 matmul kernel's bound counts its three
# tf32 passes (hi hi, hi lo, lo hi) at this rate
TF32_OPS = 495e12
# the tape's products timed in phase 3: (variant, M, N, K, A read along m,
# B given as W^T): BERT-base's decoder (PERF.md row 3, the record's main
# shape), Mistral-7B's MLP up-projection, its weight gradient with the batch
# folded into K, Pythia-1B's QKV
MATMUL_SHAPES = (("", 1024, 30522, 768, False, True),
                 ("mistral_up_", 8192, 14336, 4096, False, True),
                 ("mistral_up_dw_", 4096, 14336, 8192, True, False),
                 ("pythia_qkv_", 4096, 6144, 2048, False, True))


def serving_requests(vocab):
    """drive_serving's engine traffic (bench.py's engine benchmark): 32
    ragged greedy requests, prompts 8-48 tokens, 16-128 new tokens."""
    rng7 = np.random.default_rng(7)
    return [([int(t) for t in rng7.integers(0, vocab,
                                            int(rng7.integers(8, 49)))],
             int(rng7.integers(16, 129))) for _ in range(32)]


def engine_tick_positions(vocab, window=1024, slots=8, steps_per_tick=8):
    """The slots' positions at the first step of each tick of the engine
    as drive_serving runs it over serving_requests(vocab): the engine's own
    scheduler, on the CPU, over a stand-in model whose logits are zeros.
    The requests have no end token, so the schedule depends on their
    lengths alone.  (The middle tick is the stack kernel's shape (d).)"""
    from types import SimpleNamespace

    from lightgrad_tpu_torch import InferenceEngine
    from lightgrad_tpu_torch.models.decoding import KVFns, ParamFn

    calls = []

    def step_batch(p, caches, poss, toks):
        calls.append(poss.tolist())
        return caches, torch.zeros(slots, vocab)

    # compiled functions on the CPU re-run their pass at every call
    fns = KVFns(lambda: torch.zeros(1), ParamFn(
        lambda p, cache, toks, n: (cache, torch.zeros(vocab)), {}), None,
        step_batch=ParamFn(step_batch, {}))
    model = SimpleNamespace(cfg=SimpleNamespace(n_positions=window),
                            _kv_fns=fns)
    engine = InferenceEngine(model, slots=slots,
                             steps_per_tick=steps_per_tick)
    for p, n in serving_requests(vocab):
        engine.submit(p, n)
    assert len(engine.run()) == 32
    return calls[::steps_per_tick]


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed between two CUDA events.  Unlike :func:`cuda_ms` it leaves out
    the host's launch work, which exceeds a small kernel's run time."""
    return graph_sets_ms(fn, [()] * iters, replays=1)


def timed(results, dtype, name, err, kernel, plain, cost, library,
          iters=20, variant="", peak=None):
    """Record ``kernel``, ``plain`` and ``library`` by device time (graph
    replay)."""
    record(results, dtype, name, err, graph_ms(kernel, iters),
           graph_ms(plain, iters), timing="graph", cost=cost,
           library_ms=graph_ms(library, iters), variant=variant, peak=peak)


# operand sets of an L2-flushed timing span at least this many bytes, so that
# no replayed call finds its operands in the card's 50 MB L2
FLUSH_BYTES = 128 << 20


def own_bytes(t):
    """Bytes of the distinct elements a tensor holds: a broadcast (stride
    0) dim counts once, as an operand is read once at its own size."""
    return prod(n for n, s in zip(t.shape, t.stride()) if s) \
        * t.element_size()


def operand_sets(make):
    """Fresh operand tuples from ``make`` until they span FLUSH_BYTES (2 to
    512 of them)."""
    sets = [make()]
    size = sum(own_bytes(t) for t in sets[0] if isinstance(t, torch.Tensor))
    n = max(2, min(512, -(-FLUSH_BYTES // max(size, 1))))
    sets += [make() for _ in range(n - 1)]
    return sets


def graph_sets_ms(fn, sets, replays=3):
    """Device time of one call of ``fn``: one call on each operand set in
    turn, all captured in a CUDA graph and replayed between two CUDA
    events; sets spanning FLUSH_BYTES (:func:`operand_sets`) find their
    operands out of L2.  ``replays`` replays are timed."""
    calls = [lambda s=s: fn(*s) for s in sets]
    fn(*sets[0])
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[1]()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * len(calls))
    del graph
    torch.cuda.empty_cache()
    return ms


def timed_sets(results, dtype, name, err, kernel, plain, cost, library,
               sets, variant=""):
    """:func:`timed` over operand sets (:func:`graph_sets_ms`): ``kernel``,
    ``plain`` and ``library`` (None where PyTorch has no one call) each
    take one set's operands."""
    record(results, dtype, name, err, graph_sets_ms(kernel, sets),
           graph_sets_ms(plain, sets), timing="graph, L2 flushed",
           cost=cost, variant=variant, library_ms=None if library is None
           else graph_sets_ms(library, sets))


def ew_plain(body, n_out, ops):
    """``ew_reference`` as a graph can replay it: a Scalar operand as a 0-d
    device tensor made here, outside the capture."""
    from lightgrad_tpu_torch.ops.elementwise import Scalar, ew_reference

    dev = next(t for t in ops if isinstance(t, torch.Tensor)).device
    fixed = {i: torch.tensor(t.value, dtype=t.dtype, device=dev)
             for i, t in enumerate(ops) if isinstance(t, Scalar)}

    def plain(*xs):
        return ew_reference(body, *(fixed.get(i, x) for i, x in
                                    enumerate(xs)), n_out=n_out)
    return plain


def ew_classes(dtype, g):
    """The main paths' elementwise classes (``scripts/ab_elementwise.py``'s
    tally; PERF.md §6 row 1) as (variant, body, n_out, make, library):
    ``make`` draws one operand set, ``library`` is one PyTorch call for the
    same function (None where none is).  GELU at (1024, 3072) first: the
    record's main line."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.ops.elementwise import scalar

    dev = g.device

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def view(shape, stride):
        need = sum((n - 1) * s for n, s in zip(shape, stride)) + 1
        return rnd(need).as_strided(shape, stride)

    out = [
        ("", "f_gelu", 1, lambda: (rnd(1024, 3072),),
         lambda x: F.gelu(x, approximate="tanh")),
        ("bias_", "f_add", 1, lambda: (rnd(8, 128, 3072), rnd(3072)),
         torch.add),
        ("bn_", "f_sub", 1, lambda: (rnd(32, 64, 112, 112),
                                     rnd(1, 64, 1, 1)), torch.sub),
        ("bn_grad_", "b2_mul", 2, lambda: (
            rnd(1, 64, 1, 1).expand(32, 64, 56, 56), rnd(32, 64, 56, 56),
            rnd(32, 64, 56, 56)), None),
        ("mask_", "f_add", 1, lambda: (rnd(8, 12, 128, 128),
                                       rnd(8, 1, 1, 128)), torch.add),
        ("scalar_", "f_mul", 1, lambda: (rnd(8, 12, 128, 128),
                                         scalar(0.125, dtype)),
         lambda x, s: torch.mul(x, s.value)),
        ("trans_", "f_add", 1, lambda: (rnd(8192, 2048),
                                        rnd(2048, 8192).T), torch.add),
        ("rotary_", "f_mul", 1, lambda: (
            view((1, 8, 2048, 64), (12582912, 768, 6144, 1)),
            rnd(1, 1, 2048, 64)), torch.mul),
        ("vocab_", "b2_add", 2, lambda: (rnd(8, 128, 30522),
                                         rnd(8, 128, 30522), rnd(30522)),
         None),
        ("residual_", "f_add", 1, lambda: (rnd(1, 8192, 4096),
                                           rnd(1, 8192, 4096)), torch.add),
    ]
    if dtype == torch.float32:
        out.append(("onehot_", "f_eq", 1, lambda: (
            torch.randint(0, 32000, (8192, 1), generator=g, device=dev,
                          dtype=torch.int32),
            torch.arange(32000, device=dev, dtype=torch.int32)), None))
    return out


def errors(got, want):
    got = got.float()
    want = want.float()
    abs_err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    return abs_err, abs_err / scale


def check(name, dtype, got, want, tol):
    abs_err, rel = errors(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and rel <= tol
    log(f"  {name} {str(dtype)[6:]}: max_abs_err={abs_err:.3e} "
        f"rel={rel:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: {abs_err} (rel {rel}) > {tol}")
    return abs_err


def check_scaled(name, dtype, got, want, tol):
    """:func:`check` with the error scaled by max |ref| itself, not by
    max(1, max |ref|): for outputs whose scale is not 1."""
    got, want = got.float(), want.float()
    abs_err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and abs_err <= tol * ref
    log(f"  {name} {str(dtype)[6:]}: max_abs_err={abs_err:.3e} max|ref|="
        f"{ref:.3e} rel={abs_err / max(ref, 1e-30):.3e} tol={tol:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: {abs_err} > {tol} * {ref}")
    return abs_err


def discriminates(name, dtype, want, tol, *wrong):
    """Fail unless every output in ``wrong`` would fail :func:`check`
    against ``want``: inputs on which a broken kernel passes test nothing."""
    for w in wrong:
        if errors(w, want)[1] <= tol:
            raise AssertionError(f"{name} {dtype}: degenerate inputs, a "
                                 f"wrong output is within {tol}")


def check_rms(name, dtype, got, want, tol, *wrong):
    """:func:`check` with the error scaled by the reference's rms, not by
    max(1, max |ref|): for outputs far below 1 (attention averaging
    thousands of random value rows, ~0.03), where the latter would pass an
    error of a third of a typical value.  Every output in ``wrong`` must
    fail it."""
    rms = want.float().pow(2).mean().sqrt().item()
    abs_err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got.float()).all()) and abs_err <= tol * rms
    log(f"  {name} {str(dtype)[6:]}: max_abs_err={abs_err:.3e} "
        f"rms(ref)={rms:.3e} err/rms={abs_err / rms:.3e} tol={tol:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: {abs_err} > {tol} * rms {rms}")
    for w in wrong:
        if (w.float() - want.float()).abs().max().item() <= tol * rms:
            raise AssertionError(f"{name} {dtype}: degenerate inputs, a "
                                 f"wrong output is within {tol} * rms")
    return abs_err


# one unit in the last place of a value of the output type, relative to it
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}


def check_ulp(name, dtype, got, want, tol, *wrong, allow=None):
    """:func:`check_rms` with one unit in the last place of each reference
    element allowed beside it: |got - want| <= tol * rms + ULP |want| on
    every element.  For a causal backward, whose largest gradients (the
    first query rows') lie 10-60 rms out, where rounding a bfloat16 output
    alone moves them by a tenth of an rms.  ``allow``: a further allowance
    per element (:func:`bwd_reference`'s, for the bf16 backward).  Every
    output in ``wrong`` must fail it."""
    ref = want.float()
    rms = ref.pow(2).mean().sqrt().item()
    slack = ULP[dtype] * ref.abs()
    if allow is not None:
        slack = slack + allow.float()

    def excess(t):
        return ((t.float() - ref).abs() - slack).max().item()

    abs_err = (got.float() - ref).abs().max().item()
    over = excess(got) / rms
    ok = bool(torch.isfinite(got.float()).all()) and over <= tol
    log(f"  {name} {str(dtype)[6:]}: max_abs_err={abs_err:.3e} "
        f"rms(ref)={rms:.3e} (err - ulp)/rms={over:.3e} tol={tol:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: {over} rms past one ulp > "
                             f"{tol}")
    for w in wrong:
        if excess(w) <= tol * rms:
            raise AssertionError(f"{name} {dtype}: degenerate inputs, a "
                                 f"wrong output is within {tol} * rms")
    return abs_err


def last_rows_dropped(q, k, v, scale, rows, drop):
    """A plausible fault of a causal forward: its last ``rows`` query rows
    of each head over the keys before the last ``drop`` (a last K tile
    never loaded), f32; q (H, S, d), k and v (KV, S, d) grouped."""
    H, S, _ = q.shape
    rep = H // k.shape[0]
    qs = q[:, S - rows:].float().reshape(k.shape[0], rep, rows, -1)
    sc = torch.einsum("kgqd,ksd->kgqs", qs, k[:, :S - drop].float()) * scale
    out = torch.einsum("kgqs,ksd->kgqd", torch.softmax(sc, -1),
                       v[:, :S - drop].float())
    return out.reshape(H, rows, -1)


def check_fwd(name, dtype, out, ref, *wrong, q=None, k=None, v=None,
              scale=None, drop=0, library=None):
    """The flash forward's output against its plain version: f32 by
    :func:`check`; bf16 by :func:`check_ulp` at FWD_TOL, every output in
    ``wrong`` failing it, and, with ``drop`` (a causal call's last K tile's
    keys) where S exceeds it, its last 64 rows held apart against the same
    rows over all keys but the last ``drop``.  ``library``: the same call
    by PyTorch, whose error by the same measure is logged beside."""
    if dtype == torch.float32:
        err = check(name, dtype, out, ref, FWD_TOL[dtype])
        discriminates(name, dtype, ref, FWD_TOL[dtype], *wrong)
        return err
    err = check_ulp(name, dtype, out, ref, FWD_TOL[dtype], *wrong)
    if library is not None:
        r = ref.float()
        over = ((library.float() - r).abs() - ULP[dtype] * r.abs()).max()
        log(f"  {name} {str(dtype)[6:]}: the library's (err - ulp)/rms="
            f"{over.item() / r.pow(2).mean().sqrt().item():.3e}")
    if drop and out.shape[-2] > drop:
        rows = min(64, out.shape[-2] - drop)
        check_ulp(f"{name} last {rows} rows", dtype, out[:, -rows:],
                  ref[:, -rows:], FWD_TOL[dtype],
                  last_rows_dropped(q, k, v, scale, rows, drop))
    return err


def bwd_plain(dtype, do, q, k, v, out, lse, scale, causal, lengths=None,
              window=0):
    """The port's plain version of the two backward passes: in f32 the
    recompute backward; in bf16 the passes' own arithmetic from the
    forward's (out, lse), p and ds rounded to bf16 before their products
    as the TPU kernels do (``attention_bwd_passes_reference``)."""
    from lightgrad_tpu_torch.ops.attention import (
        attention_bwd_passes_reference, attention_bwd_reference)

    if dtype == torch.float32:
        return attention_bwd_reference(do, q, k, v, scale, causal,
                                       lengths=lengths, window=window)
    return attention_bwd_passes_reference(do, q, k, v, out, lse, scale,
                                          causal, lengths, window)


# Rounding p or ds to bf16 is a discrete decision: where the f32 value lies
# within the f32 noise of its computation (the product sums' order, exp2
# against exp) of a bf16 rounding boundary, either neighbour is the TPU
# kernels' arithmetic, and one ulp of ds at the first query rows (|ds| ~
# 16 at d 256) moves a gradient by up to a tenth of its rms.  The plain
# version's own f32 and f64 evaluations differ by 1.4e-2 of the rms past
# one ulp at these shapes (PERF.md §6).  The noise is bounded as the
# kernels compute: an f32 sum of d products errs by at most d 2^-24 of the
# sum of their magnitudes; forming exp's argument (s * scale - lse, three
# roundings) and exp2 itself add a few f32 ulps; ds's difference and
# product one each.
EPS = 2.0 ** -24


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (x f64, nonzero where it counts)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(1e-300)))
    return torch.exp2(e - 7)


def _ambiguous(x, noise):
    """One bf16 ulp where x lies within ``noise`` of a rounding boundary (a
    midpoint between two bf16 values), else 0."""
    ulp = _bf16_ulp(x)
    off = (x - x.to(torch.bfloat16).double()).abs()
    return torch.where((ulp / 2 - off <= noise) & (x != 0), ulp, 0.0)


def bwd_f64(do, q, k, v, scale, causal, lengths=None, window=0):
    """(dq, dk, dv) of the recompute backward (the f32 plain version's
    formulas) evaluated in float64: q, do (B, S, d); k, v (B/G, S, d),
    grouped; padded query rows and keys (``lengths``) get zeros."""
    B, S, d = q.shape
    KV = k.shape[0]
    q4, g4 = (t.double().reshape(KV, B // KV, S, d) for t in (q, do))
    k3, v3 = k.double(), v.double()
    i = torch.arange(S, device=q.device)
    valid = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        valid = i[None, :] <= i[:, None]
        if window:
            valid = valid & (i[:, None] - i[None, :] < window)
    valid = valid.expand(KV, B // KV, S, S)
    if lengths is not None:
        ok = (i[None, :] < lengths.reshape(B, 1).long()).reshape(
            KV, B // KV, S)
        valid = valid & ok[..., None, :] & ok[..., :, None]
    sc = torch.einsum("bgqd,bkd->bgqk", q4, k3) * scale
    p = torch.softmax(sc.masked_fill(~valid, float("-inf")), -1)
    p = torch.where(valid, p, 0.0)       # rows with no valid key: zeros
    del sc
    dp = torch.einsum("bgqd,bkd->bgqk", g4, v3)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del dp
    return (torch.einsum("bgqk,bkd->bgqd", ds, k3).reshape(q.shape) * scale,
            torch.einsum("bgqk,bgqd->bkd", ds, q4) * scale,
            torch.einsum("bgqk,bgqd->bkd", p, g4))


def bwd_reference(dtype, do, q, k, v, out, lse, scale, causal, lengths=None,
                  window=0):
    """The plain version the backward kernels are held against, and a
    per-element allowance beside one ulp of the output (None in f32).
    f32: the recompute backward (:func:`bwd_plain`'s) evaluated in f64
    (:func:`bwd_f64`): at Pythia-1B's shape the plain version's own f32
    evaluation errs against f64 by about the tolerance times the rms
    (``scripts/flash_bwd_variants.py``, PERF.md §6), so it cannot be the
    bar.  bf16: the TPU
    kernels' arithmetic (p and ds rounded to bf16 before their products,
    no dcap refinement; the two passes and the fused kernel alike)
    evaluated in f64 from the forward's (out, lse), and, per output
    element, the sum over its terms whose rounded factor sits within its
    f32 noise (EPS) of a rounding boundary of one ulp of that factor times
    the other factor's magnitude: what those roundings, taken either way,
    can move it by.  q, do (B, S, d); k, v (B/G, S, d)."""
    if dtype == torch.float32:
        return bwd_f64(do, q, k, v, scale, causal, lengths,
                       window), (None, None, None)
    f64 = torch.float64
    b, s, d = q.shape
    bkv = k.shape[0]
    G = b // bkv
    q4, g4 = (t.reshape(bkv, G, s, d).to(f64) for t in (q, do))
    k3, v3 = k.to(f64), v.to(f64)
    dcap = (do.float() * out.float()).sum(-1).reshape(bkv, G, s, 1).to(f64)
    p = torch.exp(torch.einsum("bgqd,bkd->bgqk", q4, k3) * scale
                  - lse.reshape(bkv, G, s, 1).to(f64))
    dp = torch.einsum("bgqd,bkd->bgqk", g4, v3)
    ds = p * (dp - dcap)
    i = torch.arange(s, device=q.device)
    valid = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        valid = i[None, :] <= i[:, None]
        if window:
            valid = valid & (i[:, None] - i[None, :] < window)
    valid = valid.expand(bkv, G, s, s)
    if lengths is not None:
        ok = i[None, :] < lengths.reshape(b, 1).long()            # (b, s)
        ok = ok.reshape(bkv, G, s)
        valid = valid & ok[..., None, :] & ok[..., :, None]
    p, ds = torch.where(valid, p, 0.0), torch.where(valid, ds, 0.0)
    # f32 noise bounds: p's relative one (s's sum, the argument, exp2) and
    # ds's absolute one (p's, dp's sum, the difference and the product)
    arg = (torch.log(p.clamp_min(1e-300)).abs()
           + 2 * lse.reshape(bkv, G, s, 1).to(f64).abs())
    rel = (d * EPS * scale * torch.einsum("bgqd,bkd->bgqk", q4.abs(),
                                          k3.abs())
           + 2 * EPS * arg + 4 * EPS)
    del arg
    amb_p = _ambiguous(p, p * rel)
    amb_ds = _ambiguous(ds, ds.abs() * (rel + 2 * EPS) + p * (
        d * EPS * torch.einsum("bgqd,bkd->bgqk", g4.abs(), v3.abs())
        + EPS * (dp - dcap).abs()))
    del dp, rel
    pr, dsr = (t.to(torch.bfloat16).to(f64) for t in (p, ds))
    del p, ds
    want = (torch.einsum("bgqk,bkd->bgqd", dsr, k3) * scale,
            torch.einsum("bgqk,bgqd->bkd", dsr, q4) * scale,
            torch.einsum("bgqk,bgqd->bkd", pr, g4))
    allow = (torch.einsum("bgqk,bkd->bgqd", amb_ds, k3.abs()) * scale,
             torch.einsum("bgqk,bgqd->bkd", amb_ds, q4.abs()) * scale,
             torch.einsum("bgqk,bgqd->bkd", amb_p, g4.abs()))
    return ([w.reshape(t.shape) for w, t in zip(want, (q, k, v))],
            [a.reshape(t.shape).float() for a, t in zip(allow, (q, k, v))])


def check_bwd(name, dtype, got, want, tol, *wrong, allow=None):
    """A backward output against :func:`bwd_reference`'s: f32 by
    :func:`check`; bf16 by :func:`check_ulp` at the same ``tol`` with the
    reference's rounding allowance, a zero output and every one in
    ``wrong`` failing it."""
    if dtype == torch.float32:
        return check(name, dtype, got, want, tol)
    if allow is not None:
        rms = want.double().pow(2).mean().sqrt().item()
        log(f"  {name} {str(dtype)[6:]}: rounding allowance max "
            f"{allow.max().item() / rms:.3e}, mean "
            f"{allow.mean().item() / rms:.3e} of the rms")
    return check_ulp(name, dtype, got, want, tol, torch.zeros_like(want),
                     *wrong, allow=allow)


def sdpa_bwd_ms(q, k, v, do, **kw):
    """PyTorch's SDPA backward (dq, dk and dv in one
    ``torch.autograd.grad``) by CUDA graph: the graph time of forward and
    backward together less the forward's alone (a graph captures a
    backward only with its forward).  q, k, v and do in SDPA's (B, H, S,
    d) layout; ``kw`` go to SDPA."""
    import torch.nn.functional as F

    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    both = graph_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*ts, **kw), ts, do), 10)
    with torch.no_grad():
        fwd = graph_ms(lambda: F.scaled_dot_product_attention(*ts, **kw), 10)
    return both - fwd


def bound_ms(nbytes, ops, dtype, peak=None):
    """The least time the card could take for a call: its bytes (each input
    read once, each output written once) at HBM_BPS or its operations at
    the input type's peak (``peak`` where the kernel's operations run at
    another rate), whichever is longer, and which of the two."""
    by_bytes = nbytes / HBM_BPS * 1e3
    by_ops = ops / (peak or PEAK_OPS[dtype]) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def flash_cost(dtype, nbytes, ops):
    """(cost, peak) of a flash kernel's call for :func:`record`: in f32 the
    flash kernels run every product as three tf32 passes, so the bound
    counts three times the operations at TF32_OPS, as the matmul's does."""
    if dtype == torch.float32:
        return (nbytes, 3 * ops), TF32_OPS
    return (nbytes, ops), None


def record(results, dtype, name, err, ms=None, plain_ms=None,
           timing="eager", cost=None, library_ms=None, variant="",
           graph=None, peak=None):
    """Fold one comparison (and, when timed, both times) into ``results``:
    f32 under plain keys, bf16 under ``bf16_`` keys.  ``timing`` says how
    the times were taken: "eager" (:func:`cuda_ms`, launch work included)
    or "graph" (:func:`graph_ms`, device time only).  A timed record also
    takes ``cost``, the (bytes, operations) of the timed call, for its
    bound, and ``library_ms``, one PyTorch call's time for the same
    function (None where PyTorch has none).  ``variant`` prefixes the time
    keys, and the error, of a second call shape of the kernel (e.g.
    "lengths_").  ``graph``: the kernel's CUDA-graph time beside an eager
    ``ms`` (``graph_ms``)."""
    r = results.setdefault(name, {"max_abs_err": 0.0})
    key = "" if dtype == torch.float32 else "bf16_"
    r[key + "max_abs_err"] = max(r.get(key + "max_abs_err", 0.0), err)
    if ms is not None:
        key += variant
        if variant:
            r[key + "max_abs_err"] = max(r.get(key + "max_abs_err", 0.0),
                                         err)
        r[key + "ms"], r[key + "plain_ms"] = ms, plain_ms
        r[key + "bound_ms"], r[key + "bound_by"] = bound_ms(*cost, dtype,
                                                            peak)
        r[key + "bound_share"] = r[key + "bound_ms"] / ms
        r[key + "library_ms"] = library_ms
        r.setdefault("timing", timing)
        if graph is not None:
            r[key + "graph_ms"] = graph
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        by_graph = "" if graph is None else f" ({graph:.4f} ms by graph)"
        log(f"  {name} {variant}{str(dtype)[6:]}: kernel {ms:.4f} ms"
            f"{by_graph}, plain {plain_ms:.4f} ms, library {lib}, bound "
            f"{r[key + 'bound_ms']:.4f} ms ({r[key + 'bound_by']})")


def stack_cost(n, L, d, H, lens, dtype, w_int8=False, kv_int8=False,
               R=4):
    """(bytes, operations) of one whole-stack call: the slabs (and their
    column scales), vecs, x in and out, the emitted K/V rows, and the cache
    rows the data makes visible (``lens``: the rows each slot's row reads;
    a slot shared by the n extend rows counts once, with its scales);
    operations: the 12 d x d products a row a layer, and q.k plus p.v over
    the visible cache rows and the in-flight ones."""
    isz = torch.tensor([], dtype=dtype).element_size()
    S, hd = 4 + 2 * R, d // H
    rows = sum(lens)
    nbytes = (L * S * d * d * (1 if w_int8 else isz)
              + (L * S * d * 4 if w_int8 else 0) + L * (9 + R) * d * isz
              + 2 * n * d * isz + L * 2 * n * d * isz
              + rows * L * 2 * H * (hd * (1 if kv_int8 else isz)
                                    + (4 if kv_int8 else 0)))
    seen = (n * lens[0] + n * (n + 1) // 2) if len(lens) == 1 \
        else rows + n
    ops = 2 * n * L * S * d * d + 4 * L * H * hd * seen
    return nbytes, ops


def phase_kernels(model, results):
    """Phase 3, serving kernels: each vs its plain version at the serving
    path's shapes; the stack kernel also in its six int8 instantiations on
    the model's own weights as ``quantize_serving`` stores them."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.models.gpt import quantize_rows
    from lightgrad_tpu_torch.ops.attention import (attention_fwd_res,
                                                   attention_fwd_reference)
    from lightgrad_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference, plan_splits)
    from lightgrad_tpu_torch.ops.decode_stack import (
        decode_stack, decode_stack_batch, decode_stack_batch_reference,
        decode_stack_reference, pack_gpt_stack)

    cfg = model.cfg
    L, d, H, W = cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_positions
    hd, eps, dev = d // H, cfg.layer_norm_epsilon, torch.device("cuda")
    sc = hd ** -0.5
    g = torch.Generator(device=dev).manual_seed(1)
    # int8 slabs and their f32 column scales, from the f32 weights
    qp = model.quantize_serving()._kv_functions().step.params
    model.quantize_serving(False)
    slabs8, scales8 = qp["stack#slabs"], qp["stack#scales"]
    del qp
    ticks = engine_tick_positions(cfg.vocab_size, W)
    engine_poss = ticks[len(ticks) // 2]
    log(f"  engine tick {len(ticks) // 2} of {len(ticks)}: positions "
        f"{engine_poss}")
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]
        isz = torch.tensor([], dtype=dtype).element_size()

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        # flash forward: prefill's causal attention, (H, W, hd)
        q, k, v = rnd(H, W, hd), rnd(H, W, hd), rnd(H, W, hd)
        out, lse = attention_fwd_res(q, k, v, sc, causal=True)
        ro, rl = attention_fwd_reference(q, k, v, sc, True)
        err = check_fwd("attention_fwd out", dtype, out, ro,
                        torch.zeros_like(ro),
                        attention_fwd_reference(q, k, v, sc, False)[0],
                        q=q, k=k, v=v, scale=sc, drop=64,
                        library=F.scaled_dot_product_attention(
                            q, k, v, is_causal=True))
        check("attention_fwd lse", dtype, lse, rl, KERNEL_TOL[torch.float32])
        if dtype == torch.float32:
            f32_fwd_vs_one_pass(f"attention_fwd ({H}, {W}, {hd}) causal", q,
                                k, v, sc, True, (out, lse), tol)
        cost, peak = flash_cost(dtype, 4 * H * W * hd * isz + H * W * 4,
                                2 * H * W * (W + 1) * hd)
        record(results, dtype, "attention_fwd", err,
               cuda_ms(lambda: attention_fwd_res(q, k, v, sc, True)),
               cuda_ms(lambda: attention_fwd_reference(q, k, v, sc, True)),
               cost=cost, peak=peak, library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True)))

        # decode attention: one token, (H, 1, hd) over W cache rows
        kc, vc = rnd(H, W, hd), rnd(H, W, hd)
        q1 = rnd(H, 1, hd)
        for pos in (0, 37, W - 1):
            got = decode_attention(q1, kc, vc, pos, sc)
            want = decode_attention_reference(q1, kc, vc, pos, sc)
            err = check(f"decode_attention pos={pos}", dtype, got, want, tol)
            record(results, dtype, "decode_attention", err)
        # times by CUDA graph (the device's time: a call is microseconds,
        # less than its launch work), the library's too
        timed(results, dtype, "decode_attention", 0.0,
              lambda: decode_attention(q1, kc, vc, 512, sc),
              lambda: decode_attention_reference(q1, kc, vc, 512, sc),
              ((2 * H * hd + 2 * 513 * H * hd) * isz, 4 * H * 513 * hd),
              lambda: F.scaled_dot_product_attention(q1, kc[:, :513],
                                                     vc[:, :513]))
        results["decode_attention"][("bf16_" if isz == 2 else "")
                                    + "n_split"] = plan_splits(H, W, 0, hd,
                                                               dtype)

        # whole-stack kernel on the model's own packed weights, float and
        # int8 (slabs, cache or both)
        p = {n: t.detach().to(dtype) for n, t in model.named_parameters()
             if n.startswith("h.")}
        packed = pack_gpt_stack(p, L, d)
        slabs, vecs = packed["stack#slabs"], packed["stack#vecs"]
        del p, packed
        cache = rnd(L, 2, H, W, hd)
        cache8, kvs8 = quantize_rows(cache)
        variants = (("", slabs, None, cache, None),
                    ("_int8", slabs8, scales8, cache, None),
                    ("_kvq", slabs, None, cache8, kvs8),
                    ("_int8_kvq", slabs8, scales8, cache8, kvs8))
        for sfx, sl, scl, c, kvs in variants:
            name = "decode_stack" + sfx
            for n in (1, 4):
                x = rnd(n, d)
                for pos in (0, 37, 1000):
                    got = decode_stack(x, c, pos, sl, vecs, scl, eps=eps,
                                       kv_scales=kvs)
                    want = decode_stack_reference(x, c, pos, sl, vecs, scl,
                                                  eps=eps, kv_scales=kvs)
                    err = max(check(f"{name} n={n} pos={pos} x", dtype,
                                    got[0], want[0], tol),
                              check(f"{name} n={n} pos={pos} kv", dtype,
                                    got[1], want[1], tol))
                    record(results, dtype, name, err)
            # by CUDA graph (device time): shape (a) n 1 at 512 and at 960
            # (the long-context phase), (b) n 4 at 37
            for variant, n, pos in (("", 1, 512), ("pos960_", 1, 960),
                                    ("n4_", 4, 37)):
                xt = rnd(n, d)
                record(results, dtype, name, 0.0,
                       graph_ms(lambda: decode_stack(
                           xt, c, pos, sl, vecs, scl, eps=eps,
                           kv_scales=kvs)),
                       graph_ms(lambda: decode_stack_reference(
                           xt, c, pos, sl, vecs, scl, eps=eps,
                           kv_scales=kvs), 3), timing="graph",
                       variant=variant,
                       cost=stack_cost(n, L, d, H, [pos], dtype,
                                       scl is not None, kvs is not None))
        del cache, cache8, kvs8
        B = 8
        caches = rnd(B, L, 2, H, W, hd)
        caches8, bkvs8 = quantize_rows(caches)
        poss = torch.tensor([0, 5, 37, 100, 511, 1000, 1023, 17],
                            device=dev, dtype=torch.int32)
        xb = rnd(B, d)
        variants = (("", slabs, None, caches, None),
                    ("_int8", slabs8, scales8, caches, None),
                    ("_kvq", slabs, None, caches8, bkvs8),
                    ("_int8_kvq", slabs8, scales8, caches8, bkvs8))
        # shape (d): the middle tick of the engine's own traffic
        poss_e = torch.tensor(engine_poss, device=dev, dtype=torch.int32)
        for sfx, sl, scl, c, kvs in variants:
            name = "decode_stack_batch" + sfx
            for variant, pt in (("", poss), ("engine_", poss_e)):
                got = decode_stack_batch(xb, c, pt, sl, vecs, scl, eps=eps,
                                         kv_scales=kvs)
                want = decode_stack_batch_reference(xb, c, pt, sl, vecs, scl,
                                                    eps=eps, kv_scales=kvs)
                tag = f"{name} B=8 {variant or 'smoke_'}poss"
                err = max(check(f"{tag} x", dtype, got[0], want[0], tol),
                          check(f"{tag} kv", dtype, got[1], want[1], tol))
                record(results, dtype, name, err,
                       graph_ms(lambda: decode_stack_batch(
                           xb, c, pt, sl, vecs, scl, eps=eps,
                           kv_scales=kvs)),
                       graph_ms(lambda: decode_stack_batch_reference(
                           xb, c, pt, sl, vecs, scl, eps=eps,
                           kv_scales=kvs), 3), timing="graph",
                       variant=variant,
                       cost=stack_cost(B, L, d, H, pt.tolist(), dtype,
                                       scl is not None, kvs is not None))
        del caches, caches8, bkvs8, slabs, vecs
        torch.cuda.empty_cache()


def plain_forward(model, ids, p=None, routes=None, moe_out=None):
    """Logits (..., T, vocab) of a full causal forward of ``ids`` (..., T)
    through the plain PyTorch versions of the kernels: no cache, no
    hand-written kernel -- the reference the KV path and, under autograd,
    the training step must meet.  ``p`` replaces the model's parameters
    (a "head.weight" entry replaces the tied head).  An MoE block runs
    ``moe_reference`` (the one-hot products), with layer l's expert choices
    ``routes[l]`` where given; ``moe_out`` then collects, a block, (aux,
    z, its own choices, its kept routings, its router probabilities)."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.models._torch_layers import moe_reference
    from lightgrad_tpu_torch.ops.attention import attention_fwd_reference
    from lightgrad_tpu_torch.ops.layernorm import layernorm_fwd_reference

    cfg = model.cfg
    p = dict(model.named_parameters()) if p is None else p
    *lead, T = ids.shape
    d, H = cfg.n_embd, cfg.n_head
    eps = cfg.layer_norm_epsilon

    def ln(x, pre):
        return layernorm_fwd_reference(x, p[pre + ".weight"],
                                       p[pre + ".bias"], eps)[0]

    def lin(x, pre):
        return F.linear(x, p[pre + ".weight"], p[pre + ".bias"])

    def moe(h, pre, l):
        w = {n[len(pre):]: t for n, t in p.items() if n.startswith(pre)}
        y, aux, z, (own, kept) = moe_reference(
            h, w, cfg.n_experts, dispatch=cfg.moe_dispatch, k=cfg.moe_k,
            capacity_factor=cfg.moe_capacity_factor,
            ids=None if routes is None else routes[l])
        if moe_out is not None:
            probs = torch.softmax(F.linear(h.reshape(-1, d), w[
                "router.weight"]).float(), -1)
            moe_out.append((aux, z, own, kept, probs.detach()))
        return y

    x = p["wte.weight"][ids] + p["wpe.weight"][:T]
    for l in range(cfg.n_layer):
        pre = f"h.{l}."
        qkv = lin(ln(x, pre + "ln_1"), pre + "attn.c_attn")
        q, k, v = (t.reshape(*lead, T, H, d // H).transpose(-3, -2)
                   for t in qkv.split(d, -1))
        att = attention_fwd_reference(q, k, v, (d // H) ** -0.5, True)[0]
        x = x + lin(att.transpose(-3, -2).reshape(*lead, T, d),
                    pre + "attn.c_proj")
        if pre + "moe.w1" in p:
            x = x + moe(ln(x, pre + "ln_2"), pre + "moe.", l)
            continue
        x = x + lin(F.gelu(lin(ln(x, pre + "ln_2"), pre + "c_fc"),
                           approximate="tanh"), pre + "c_proj")
    return ln(x, "ln_f") @ p.get("head.weight", p["wte.weight"]).T


def teacher_forced(model, dtype, rng):
    """Prefill + 4 cached steps on both branches vs plain_forward."""
    seq = [int(t) for t in rng.integers(0, model.cfg.vocab_size, 20)]
    P = 16
    with torch.no_grad():
        want = plain_forward(model, torch.tensor(
            seq, device=model.wte.weight.device))
    for branch, pack in (("packed", None), ("unrolled", False)):
        check(f"teacher-forced {branch} logits", dtype,
              forced_logits(model, seq, P, pack), want[P - 1:],
              PATH_TOL[dtype])
    torch.cuda.empty_cache()


def drive_serving(model, rng):
    """``generate`` (32 tokens), ``generate_batch`` (4 ragged prompts) and
    an engine over 32 ragged greedy requests, with their tok/s, the
    engine's peak device memory and its cache's bytes.  Returns the
    ``generate`` prompt."""
    from lightgrad_tpu_torch import InferenceEngine

    vocab = model.cfg.vocab_size
    prompt = [int(t) for t in rng.integers(0, vocab, 12)]
    model.generate(prompt, max_new_tokens=4)     # packs weights, warms cuBLAS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert len(out) == len(prompt) + 32 and all(0 <= t < vocab for t in out)
    log(f"  generate: 32 tokens in {dt:.3f} s ({32 / dt:.1f} tok/s, "
        f"prefill included)")

    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in (5, 17, 9, 30)]
    t0 = time.perf_counter()
    outs = model.generate_batch(prompts, max_new_tokens=24)
    dt = time.perf_counter() - t0
    assert [len(o) for o in outs] == [len(pr) + 24 for pr in prompts]
    log(f"  generate_batch: 4 x 24 tokens in {dt:.3f} s "
        f"({96 / dt:.1f} tok/s)")

    # the serving traffic of bench.py's engine benchmark: 32 ragged greedy
    # requests, prompts 8-48 tokens, 16-128 new tokens
    reqs = serving_requests(vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(model, slots=8, steps_per_tick=8)
    handles = [engine.submit(p, n) for p, n in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert len(done) == 32 and all(r.done for r in handles)
    for r, (_, n) in zip(handles, reqs):
        assert r.n_generated == n, (r.id, r.n_generated, n)
        assert all(0 <= t < vocab for t in r.tokens)
    ntok = sum(n for _, n in reqs)
    caches = engine._caches if isinstance(engine._caches, tuple) \
        else (engine._caches,)
    cache_mb = sum(c.numel() * c.element_size() for c in caches) / 1e6
    log(f"  engine: 32 requests, {ntok} tokens in {dt:.3f} s "
        f"({ntok / dt:.1f} tok/s; {engine.stats}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, cache "
        f"{cache_mb:.1f} MB")
    del engine, caches
    return prompt


def phase_main_path(model, dtype):
    """Phase 4 for one dtype; returns the kernels' launch counts."""
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    rng = np.random.default_rng(3)
    prompt = drive_serving(model, rng)
    # the unrolled branch is the same entry point without the packed stack
    model._kv_fns = model._kv_functions(pack_stack=False)
    out_u = model.generate(prompt, max_new_tokens=8)
    assert len(out_u) == len(prompt) + 8
    del model._kv_fns
    torch.cuda.synchronize()
    counts = launch_counts()        # the check below is not the main path
    teacher_forced(model, dtype, rng)
    return counts


def dequantized(model):
    """The parameters of a ``quantize_serving`` model with each int8 matrix
    replaced by its dequantized value (int8 x scale, in the compute dtype)
    and the LM head's int8 copy as "head.weight"."""
    qp = model._kv_functions(pack_stack=False).step.params
    p = dict(model.named_parameters())
    for n in [n for n in qp if n.endswith("#q")]:
        base = n[:-2]
        w = qp[n].float() * qp[base + "#s"].float()[:, None]
        p["head.weight" if base == "head" else base] = w.to(
            model.wte.weight.dtype)
    return p


def forced_logits(model, seq, P, pack):
    """Prefill of seq[:P], then one cached step a token: (len - P + 1,
    vocab) logits."""
    fns = model._kv_functions(pack_stack=pack)
    assert ("stack#slabs" in fns.step.params) == (pack is None)
    dev = model.wte.weight.device
    toks = torch.zeros(model.cfg.n_positions, dtype=torch.long)
    toks[:P] = torch.tensor(seq[:P])
    with torch.no_grad():
        cache, lg = fns.prefill(fns.init_cache(), toks.to(dev), P)
        rows = [lg]
        for pos in range(P, len(seq)):
            cache, lg = fns.step(cache, pos, seq[pos])
            rows.append(lg)
    return torch.stack(rows)


def decisive_tokens(name, got, want):
    """Greedy tokens of ``got`` equal ``want``'s at every step whose top-2
    gap in ``want`` exceeds 10x that step's deviation (tests/
    test_kv_quant.py's rule): there a flip is arithmetically impossible."""
    got, want = got.float(), want.float()
    dev = (got - want).abs().amax(-1).clamp_min(1e-6)
    top2 = want.topk(2, -1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 10 * dev
    flips = decisive & (got.argmax(-1) != want.argmax(-1))
    log(f"  {name}: max deviation {dev.max().item():.3e}; "
        f"{int(decisive.sum())} of {len(dev)} steps decisive, tokens "
        f"{'agree' if not flips.any() else 'FAIL'} there")
    if flips.any():
        raise AssertionError(f"{name}: greedy token flips at decisive steps "
                             f"{flips.nonzero().flatten().tolist()}")


def teacher_forced_int8(model, dtype, mode, rng):
    """Prefill of 16 tokens + 32 cached steps on both branches.  int8
    weights: each branch against a plain forward over the dequantized
    weights at PATH_TOL.  int8 cache: the branches against each other at
    PATH_TOL, and the packed one's greedy tokens against the float cache's
    (same weights) by the decisive-gap rule."""
    seq = [int(t) for t in rng.integers(0, model.cfg.vocab_size, 48)]
    P = 16
    got = {b: forced_logits(model, seq, P, pack)
           for b, pack in (("packed", None), ("unrolled", False))}
    dev = model.wte.weight.device
    with torch.no_grad():
        want = None
        if mode != "quantize_kv":
            want = plain_forward(model, torch.tensor(seq, device=dev),
                                 dequantized(model))[P - 1:]
        if mode == "quantize_serving":
            for b, lg in got.items():
                check(f"teacher-forced {mode} {b} vs the dequantized "
                      f"plain forward", dtype, lg, want, PATH_TOL[dtype])
            return
        check(f"teacher-forced {mode} packed vs unrolled", dtype,
              got["packed"], got["unrolled"], PATH_TOL[dtype])
        if want is None:              # the float cache, same weights
            model.quantize_kv(False)
            want = forced_logits(model, seq, P, None)
            model.quantize_kv(True)
        decisive_tokens(f"teacher-forced {mode} vs the float cache",
                        got["packed"], want)
    del got, want
    torch.cuda.empty_cache()


def phase_int8_serving(model, draft, dtype):
    """int8 serving for one dtype under each of quantize_serving,
    quantize_kv and both: the serving entry points, the decoding module's
    (the draft unquantized), then the teacher-forced checks.  Returns
    {mode: (launch counts, {decoding path: launch counts})}."""
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    counts = {}
    for mode in INT8_MODES:
        log(f"  int8 serving, {mode}:")
        if mode != "quantize_kv":
            model.quantize_serving()
        if mode != "quantize_serving":
            model.quantize_kv()
        reset_launch_counts()
        rng = np.random.default_rng(4)
        drive_serving(model, rng)
        torch.cuda.synchronize()
        served = launch_counts()   # before the checks' own launches
        counts[mode] = (served, drive_device_decoding(
            model, draft, dtype, f"{mode} ({dtype})"))
        teacher_forced_int8(model, dtype, mode, rng)
        model.quantize_serving(False).quantize_kv(False)
        torch.cuda.empty_cache()
    return counts


def phase_long_context(model, card):
    """The regime the int8 cache is for: a 960-token prompt and 48 new
    tokens through ``generate``, float cache and ``quantize_kv``; the
    decode rate leaves out the prefill (a 1-token run timed apart).  Then
    ``generate`` against ``generate_device`` at that context (float
    cache): wall and device ms a token, idle share, kernels a token."""
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(0, model.cfg.vocab_size, 960)]
    outs = {}
    for quant in (False, True):
        model.quantize_kv(quant)
        model.generate(prompt[:8], max_new_tokens=2)        # packs, warms
        times = []
        for n in (1, 48):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[quant] = model.generate(prompt, max_new_tokens=n)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        assert len(outs[quant]) == 960 + 48
        per_tok = (times[1] - times[0]) / 47
        log(f"  long context, {'int8' if quant else 'float'} cache: 48 "
            f"tokens after 960 in {times[1]:.3f} s ({48 / times[1]:.1f} "
            f"tok/s with prefill; prefill {times[0]:.3f} s; decode "
            f"{per_tok * 1e3:.3f} ms/token, {1 / per_tok:.1f} tok/s)")
    same = sum(a == b for a, b in zip(outs[False][960:], outs[True][960:]))
    log(f"  long context: {same} of 48 greedy tokens equal between the "
        f"caches (random weights: near-ties are common)")
    model.quantize_kv(False)
    decode_rates(model, "GPT-2 small", prompt, DEVICE_NEW, card)


@contextlib.contextmanager
def eager_decoding():
    """Every compiled decode function (``ParamFn``) called through its
    ``.fn``: the eager path the CUDA graphs are held against."""
    from lightgrad_tpu_torch.models.decoding import ParamFn

    call = ParamFn.__call__
    ParamFn.__call__ = lambda self, *a: self.fn(self.params, *a)
    try:
        yield
    finally:
        ParamFn.__call__ = call


def sync_free(fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("error"): any host
    read of a device value raises, except the decoding module's counted
    transfers (``_host_io``: a prompt upload, a readback, the speculative
    loop's (n, done) a round), which run with the mode off."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def path_run(counts, path, fn):
    """``fn()`` with the kernels' launch counts and the decoding module's
    host transfers set to 0 before and read after, into counts[path]."""
    from lightgrad_tpu_torch.models import decoding
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    decoding.host_transfers.clear()
    out = fn()
    torch.cuda.synchronize()
    counts[path] = launch_counts()
    return out, dict(decoding.host_transfers)


def forced_rows(model, seq, P):
    """The model's decode functions (as they stand) teacher-forced along
    ``seq``: prefill of seq[:P], then a cached step a token; row j is the
    logits that predict seq[P + j]."""
    from lightgrad_tpu_torch.models.decoding import _device

    fns = model._kv_fns
    W = model.cfg.n_positions if hasattr(model.cfg, "n_positions") \
        else model.cfg.max_position_embeddings
    cache = fns.init_cache()
    toks = torch.zeros(W, dtype=torch.long)
    toks[:P] = torch.tensor(seq[:P])
    with torch.no_grad():
        cache, lg = fns.prefill(cache, toks.to(_device(cache)), P)
        rows = [lg.float()]
        for pos in range(P, len(seq) - 1):
            cache, lg = fns.step(cache, pos, seq[pos])
            rows.append(lg.float())
    del cache
    return torch.stack(rows)


def seq_logprob(model, seq, P):
    """Sum of log p(seq[t] | seq[:t]) over the generated tokens, float64,
    through the model's cached steps."""
    rows = forced_rows(model, seq, P).double().log_softmax(-1)
    return float(rows[torch.arange(len(rows)), torch.tensor(
        seq[P:], device=rows.device)].sum())


def same_greedy(name, model, got, want, P, tol):
    """Greedy tokens ``got`` equal ``want`` (prompt + generated, P prompt
    tokens), or first differ where ``want``'s own logits hold a near-tie:
    ``got``'s token within ``tol`` times the row's largest |logit| of the
    top (the two paths' kernels sum in other orders).  Returns 1 for such a
    divergence, else 0."""
    if got == want:
        return 0
    j = next(i for i, (a, b) in enumerate(zip(got[P:], want[P:])) if a != b)
    row = forced_rows(model, want[:P + j + 1], P)[j]
    top, scale = row.max().item(), row.abs().max().item()
    gap = top - row[got[P + j]].item()
    log(f"  {name}: first differs at generated token {j} ({got[P + j]} for "
        f"{want[P + j]}), a near-tie of the reference's logits: "
        f"{gap:.3e} below the top, max |logit| {scale:.3e}")
    if gap > tol * scale:
        raise AssertionError(f"{name}: greedy tokens differ at token {j} "
                             f"where the reference's top-2 gap is {gap:.3e}")
    return 1


class AcceptCount:
    """Wraps a model's ``extend`` (the speculative verify pass) to count
    the greedy rounds and the draft proposals the target accepted: the
    leading proposals equal to the target's argmax.  The counts are device
    tensors added to in place, so a compiled round (the device loop's
    graph, which calls ``.fn`` when it is recorded and captured) counts at
    each replay; read once at the end."""

    def __init__(self, model):
        self.fns, self.extend = model._kv_fns, model._kv_fns.extend
        self.params = self.extend.params
        self.counts = torch.zeros(2, dtype=torch.long,
                                  device=model.wte.weight.device)
        self.rounds = 0
        self.fns.extend = self

    def _count(self, toks, rows):
        hit = toks[1:] == rows.argmax(-1)[:-1]
        self.counts.add_(torch.stack([torch.ones_like(self.counts[0]),
                                      hit.long().cumprod(0).sum()]))
        return rows

    def fn(self, p, cache, pos0, toks):
        cache, rows = self.extend.fn(p, cache, pos0, toks)
        return cache, self._count(toks, rows)

    def __call__(self, cache, pos0, toks):
        cache, rows = self.extend(cache, pos0, toks)
        return cache, self._count(toks, rows)

    def close(self, k):
        self.fns.extend = self.extend
        self.rounds, acc = self.counts.tolist()
        return acc / max(1, k * self.rounds)


def drive_device_decoding(model, draft, dtype, tag):
    """The decoding module on GPT-2 small after the long-context prompt:
    ``generate_device`` (greedy: ``generate``'s tokens; sampled: repeats
    under its seed), ``generate_batch_device`` over 8 ragged prompts
    (each row the single run's), beam search (beam 1 is greedy; beam
    BEAM_WIDTH scores no worse), ``generate_speculative`` and
    ``generate_speculative_device`` with a DRAFT_LAYERS-layer draft (greedy
    tokens), and an engine of sampled requests.  Every device loop and
    the engine run under sync debug mode "error".  Returns {path: launch
    counts}."""
    from lightgrad_tpu_torch import InferenceEngine
    from lightgrad_tpu_torch.models.decoding import (
        beam_search, generate_speculative, generate_speculative_device)

    vocab, N = model.cfg.vocab_size, DEVICE_NEW
    rng = np.random.default_rng(6)
    prompt = [int(t) for t in rng.integers(0, vocab, DEVICE_PROMPT)]
    P = len(prompt)
    tol = PATH_TOL[dtype]
    counts = {}
    want = model.generate(prompt, max_new_tokens=N)
    got, io = path_run(counts, "generate_device", lambda: sync_free(
        lambda: model.generate_device(prompt, N)))
    if got != want:
        raise AssertionError(f"{tag}: generate_device's greedy tokens "
                             f"differ from generate's: {got[P:]} "
                             f"{want[P:]}")
    a = sync_free(lambda: model.generate_device(prompt, N, seed=7,
                                                **SAMPLED))
    b = model.generate_device(prompt, N, seed=7, **SAMPLED)
    c = model.generate_device(prompt, N, seed=8, **SAMPLED)
    assert a == b, "a sampled generate_device did not repeat under its seed"
    assert all(0 <= t < vocab for t in a)
    log(f"  generate_device: {N} greedy tokens after {P} equal generate's "
        f"(host transfers {io}); sampled {SAMPLED} repeats under its seed, "
        f"another seed {'differs' if a != c else 'gives the same tokens'}")

    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in DEVICE_BATCH]
    got_b, io = path_run(counts, "generate_batch_device", lambda: sync_free(
        lambda: model.generate_batch_device(prompts, N)))
    near = sum(same_greedy(f"{tag} generate_batch_device row {i}", model,
                           g, model.generate_device(p, N), len(p), tol)
               for i, (p, g) in enumerate(zip(prompts, got_b)))
    log(f"  generate_batch_device: {len(prompts)} ragged prompts "
        f"{list(DEVICE_BATCH)}, {N} tokens each: {len(prompts) - near} rows "
        f"equal the single runs, {near} first differ at a near-tie (host "
        f"transfers {io})")

    b1 = beam_search(model, prompt, N, beam_size=1)
    if b1 != want:
        raise AssertionError(f"{tag}: beam 1 differs from greedy")
    bw, _ = path_run(counts, "beam_search", lambda: beam_search(
        model, prompt, N, beam_size=BEAM_WIDTH))
    lp_b, lp_g = seq_logprob(model, bw, P), seq_logprob(model, want, P)
    log(f"  beam_search: beam 1 equals greedy; beam {BEAM_WIDTH} log-prob "
        f"{lp_b:.4f}, greedy {lp_g:.4f}")
    if lp_b < lp_g - 1e-6 * abs(lp_g):
        raise AssertionError(f"{tag}: beam {BEAM_WIDTH} scores below greedy")

    acc = AcceptCount(model)
    self_spec = sync_free(lambda: generate_speculative_device(
        model, model, prompt, N, k=SPEC_K))
    self_rate, self_rounds = acc.close(SPEC_K), acc.rounds
    same_greedy(f"{tag} generate_speculative_device, the target as its "
                f"own draft", model, self_spec, want, P, tol)
    acc = AcceptCount(model)
    spec, _ = path_run(counts, "generate_speculative",
                       lambda: generate_speculative(model, draft, prompt, N,
                                                    k=SPEC_K))
    host_rate, host_rounds = acc.close(SPEC_K), acc.rounds
    acc = AcceptCount(model)
    spec_d, io = path_run(counts, "generate_speculative_device",
                          lambda: sync_free(lambda: generate_speculative_device(
                              model, draft, prompt, N, k=SPEC_K)))
    rate = acc.close(SPEC_K)
    reads = io["generate_speculative_device"]
    for what, out in (("generate_speculative", spec),
                      ("generate_speculative_device", spec_d)):
        same_greedy(f"{tag} {what}", model, out, want, P, tol)
    log(f"  speculative, {DRAFT_LAYERS}-layer draft, k {SPEC_K}: host loop "
        f"{host_rounds} rounds, acceptance {host_rate:.3f}; device loop "
        f"{acc.rounds} rounds, acceptance {rate:.3f}, {reads} host transfers "
        f"(2 uploads, {reads - 3} reads of (n, done), 1 readback); the "
        f"target as its own draft {self_rounds} rounds, acceptance "
        f"{self_rate:.3f}; greedy tokens "
        f"{'equal' if spec == want and spec_d == want else 'checked'} "
        f"against generate's")
    if reads - 3 != acc.rounds + 1:
        raise AssertionError(f"{tag}: the speculative device loop read the "
                             f"host {reads} times for {acc.rounds} rounds")

    g = torch.Generator(device=model.wte.weight.device).manual_seed(5)
    engine = InferenceEngine(model, slots=4, steps_per_tick=4, generator=g)
    reqs = [engine.submit(p, 12, **SAMPLED) for p in prompts[-4:]]
    _, io = path_run(counts, "engine (sampled)", lambda: sync_free(engine.run))
    assert all(r.n_generated == 12 and all(0 <= t < vocab for t in r.tokens)
               for r in reqs)
    log(f"  engine: 4 sampled requests in {engine.stats['step_dispatches']} "
        f"ticks under sync debug mode \"error\" (host transfers {io})")
    del engine
    torch.cuda.empty_cache()
    return counts


def decode_rates(model, name, prompt, n, card):
    """Wall and device ms a token of ``generate`` (the host loop: one
    logits readback and host sampling a token) and ``generate_device`` (no
    read inside the loop) after ``prompt``: runs of 1 and ``n`` new tokens,
    the difference over n - 1 (the prefill cancels).  Wall time from
    unprofiled runs in the order generate, generate_device,
    generate_device, generate (the host's pace drifts within a call);
    device time, kernels and copies from torch.profiler traces of runs of
    1 and PROFILED_NEW tokens (a trace of n tokens at Mistral-7B's 1360
    kernels a token costs tens of seconds to read).  Records, not gates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fns = {"generate": lambda k: model.generate(prompt, max_new_tokens=k),
           "generate_device": lambda k: model.generate_device(prompt, k)}

    def per_token(fn):
        wall = []
        for k in (1, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(k)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        return (wall[1] - wall[0]) / (n - 1)

    for fn in fns.values():
        fn(2)
    walls = {what: [] for what in fns}
    for what in ("generate", "generate_device", "generate_device",
                 "generate"):
        walls[what].append(per_token(fns[what]))
    m = PROFILED_NEW
    for what, fn in fns.items():
        busy, kernels, copies = [], [], []
        for k in (1, m):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as trace:
                fn(k)
                torch.cuda.synchronize()
            ev = [e for e in trace.events() if e.device_type == DeviceType.CUDA]
            cp = sum(e.name.startswith(("Memcpy", "Memset")) for e in ev)
            busy.append(sum(e.time_range.elapsed_us() for e in ev) / 1e3)
            kernels.append(len(ev) - cp)
            copies.append(cp)
        dev_ms = (busy[1] - busy[0]) / (m - 1)
        lo, hi = min(walls[what]), max(walls[what])
        log(f"  {name} {what}, {n} tokens after {len(prompt)}: "
            f"{lo:.3f}-{hi:.3f} ms a token of wall time (two runs), "
            f"{dev_ms:.3f} device ms (idle {100 * (1 - dev_ms / lo):.1f}-"
            f"{100 * (1 - dev_ms / hi):.1f}%), "
            f"{(kernels[1] - kernels[0]) / (m - 1):.1f} kernels and "
            f"{(copies[1] - copies[0]) / (m - 1):.1f} copies a token "
            f"({m}-token traces); {card}")


def f32_passes_vs_one_pass(tag, do, q, k, v, out, lse, scale, causal, got,
                           tol):
    """The f32 passes' (dq, dk, dv) ``got`` against the float64 backward
    (:func:`bwd_f64`) within ``tol`` of max(1, the largest |element|),
    a bar the same arithmetic with one tf32 pass a product must fail: the
    kernels are three tf32 passes, not TF32.  Returns the kernels' error."""
    from lightgrad_tpu_torch.ops.attention import \
        attention_bwd_tf32x3_reference
    from lightgrad_tpu_torch.ops.matmul import tf32_round

    def one_pass(a, b):
        return torch.matmul(tf32_round(a).double(),
                            tf32_round(b).double()).float()

    want = bwd_f64(do, q, k, v, scale, causal)
    one = attention_bwd_tf32x3_reference(do, q, k, v, out, lse, scale,
                                         causal, product=one_pass)

    def err(xs):
        return max(((x.double() - w).abs().max()
                    / w.abs().max().clamp_min(1.0)).item()
                   for x, w in zip(xs, want))

    kernel, single = err(got), err(one)
    ok = kernel <= tol < single
    log(f"  {tag} f32 against f64: kernels {kernel:.3e}, one tf32 pass "
        f"{single:.3e}, tol {tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: f32 passes {kernel}, one tf32 pass "
                             f"{single} against {tol}")
    return kernel


def f32_fwd_vs_one_pass(tag, q, k, v, scale, causal, got, tol):
    """The f32 forward's (out, lse) ``got`` against the forward evaluated
    in float64 within ``tol`` of max(1, the largest |element|), a bar the
    same arithmetic with one tf32 pass a product must fail: the kernel is
    three tf32 passes, not TF32.  Logs the plain f32 version's error beside
    it.  Returns the kernel's error."""
    from lightgrad_tpu_torch.ops.attention import (
        attention_fwd_reference, attention_fwd_tf32x3_reference)
    from lightgrad_tpu_torch.ops.matmul import tf32_round

    def one_pass(a, b):
        return torch.matmul(tf32_round(a).double(),
                            tf32_round(b).double()).float()

    want = attention_fwd_reference(q.double(), k.double(), v.double(), scale,
                                   causal)

    def err(xs):
        return max(((x.double() - w).abs().max()
                    / w.abs().max().clamp_min(1.0)).item()
                   for x, w in zip(xs, want))

    kernel = err(got)
    single = err(attention_fwd_tf32x3_reference(q, k, v, scale, causal,
                                                product=one_pass))
    plain = err(attention_fwd_reference(q, k, v, scale, causal))
    ok = kernel <= tol < single
    log(f"  {tag} f32 against f64: kernel {kernel:.3e}, plain f32 "
        f"{plain:.3e}, one tf32 pass {single:.3e}, tol {tol:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: f32 forward {kernel}, one tf32 pass "
                             f"{single} against {tol}")
    return kernel


def phase_train_kernels(results):
    """Phase 3, training kernels: the flash backward and the LayerNorm
    kernels vs their plain versions, at the training path's shapes."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_dkv, attention_bwd_dq, attention_fwd_res)
    from lightgrad_tpu_torch.ops.layernorm import (
        layernorm_bwd, layernorm_bwd_dx, layernorm_bwd_dx_reference,
        layernorm_bwd_reference, layernorm_fwd, layernorm_fwd_reference,
        layernorm_fwd_stats, layernorm_fwd_stats_reference)

    cfg = GPT2_SMALL
    d, H, T = cfg["n_embd"], cfg["n_head"], cfg["n_positions"]
    hd, dev = d // H, torch.device("cuda")
    B = TRAIN_BATCH
    g = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]
        isz = torch.tensor([], dtype=dtype).element_size()

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        # flash backward: GPT-2's training shape (B*H, T, hd) causal, then
        # a grouped-query (G = 2) and a non-causal case at a small shape
        for bh, G, S, causal in ((B * H, 1, T, True), (8, 2, 200, True),
                                 (8, 1, 200, False)):
            q, do = rnd(bh, S, hd), rnd(bh, S, hd)
            k, v = rnd(bh // G, S, hd), rnd(bh // G, S, hd)
            sc = hd ** -0.5
            out, lse = attention_fwd_res(q, k, v, sc, causal)
            got = attention_bwd(do, q, k, v, sc, causal, out=out, lse=lse)
            want, allow = bwd_reference(dtype, do, q, k, v, out, lse, sc,
                                        causal)
            tag = f"attention_bwd ({bh}, {S}, {hd}) G={G} causal={causal}"
            errs = [check_bwd(f"{tag} {n}", dtype, a, w, tol, allow=al)
                    for n, a, w, al in zip(("dq", "dk", "dv"), got, want,
                                           allow)]
            del want, allow
            record(results, dtype, "attention_bwd_dq", errs[0])
            record(results, dtype, "attention_bwd_dkv", max(errs[1:]))
            if S != T:
                continue
            if dtype == torch.float32:      # 8 of the heads, in f64
                f32_passes_vs_one_pass(tag, do[:8], q[:8], k[:8], v[:8],
                                       out[:8], lse[:8], sc, causal,
                                       [t[:8] for t in got], tol)
            dcap = (do.float() * out.float()).sum(-1).contiguous()
            plain_ms = cuda_ms(lambda: bwd_plain(
                dtype, do, q, k, v, out, lse, sc, causal), 5)
            # the library's backward computes dq, dk and dv in one call: its
            # time (by CUDA graph) stands beside both passes
            q4, k4, v4, do4 = (t.reshape(B, H, S, hd) for t in (q, k, v, do))
            lib_ms = library_time("attention_bwd", dtype, lambda: sdpa_bwd_ms(
                q4, k4, v4, do4, is_causal=True))
            ts = [t.detach().requires_grad_() for t in (q4, k4, v4)]
            o4 = F.scaled_dot_product_attention(*ts, is_causal=True)
            eager = cuda_ms(lambda: torch.autograd.grad(
                o4, ts, do4, retain_graph=True), 5)
            log(f"  attention_bwd SDPA {str(dtype)[6:]}: {eager:.4f} ms "
                f"eager")
            tile = bh * S * hd * isz
            pairs = bh * S * (S + 1) * hd      # causal: half of S x S
            dq_fn = lambda: attention_bwd_dq(do, q, k, v, lse, dcap, sc,
                                             causal)
            dkv_fn = lambda: attention_bwd_dkv(do, q, k, v, lse, dcap, sc,
                                               causal)
            cost, peak = flash_cost(dtype, 5 * tile + 2 * bh * S * 4,
                                   3 * pairs)
            record(results, dtype, "attention_bwd_dq", 0.0, cuda_ms(dq_fn),
                   plain_ms, cost=cost, library_ms=lib_ms,
                   graph=graph_ms(dq_fn), peak=peak)
            cost, peak = flash_cost(dtype, 6 * tile + 2 * bh * S * 4,
                                   4 * pairs)
            record(results, dtype, "attention_bwd_dkv", 0.0, cuda_ms(dkv_fn),
                   plain_ms, cost=cost, library_ms=lib_ms,
                   graph=graph_ms(dkv_fn), peak=peak)
            del q4, k4, v4, do4, ts, o4
            whole = cuda_ms(lambda: attention_bwd(do, q, k, v, sc, causal,
                                                  out=out, lse=lse))
            log(f"  attention_bwd {str(dtype)[6:]}: rowsum + both kernels "
                f"{whole:.4f} ms, plain {plain_ms:.4f} ms (the plain time "
                f"stands beside each pass)")
            del q, do, k, v, out, lse, got, dcap
            torch.cuda.empty_cache()

        # LayerNorm at the training path's rows: (B*T, d).  The autograd
        # Functions run layernorm_fwd_stats (y and the row statistics) and
        # layernorm_bwd (dx, dw, db); the JAX signatures' xhat forward and
        # dx-only backward are checked and timed beside them
        x = rnd(B * T, d) * 2.0 + 0.5
        w, b = rnd(d), rnd(d)
        y, mean, rstd = layernorm_fwd_stats(x, w, b, 1e-5)
        ry, rmean, rrstd = layernorm_fwd_stats_reference(x, w, b, 1e-5)
        f32_tol = KERNEL_TOL[torch.float32]
        err = max(check("layernorm_fwd_stats y", dtype, y, ry, tol),
                  check("layernorm_fwd_stats mean", dtype, mean, rmean,
                        f32_tol),
                  check("layernorm_fwd_stats rstd", dtype, rstd, rrstd,
                        f32_tol))
        discriminates("layernorm_fwd", dtype, ry, tol, torch.zeros_like(ry))
        _, xhat, rstd2 = layernorm_fwd(x, w, b, 1e-5)
        _, rxhat, _ = layernorm_fwd_reference(x, w, b, 1e-5)
        err = max(err, check("layernorm_fwd xhat", dtype, xhat, rxhat,
                             f32_tol),
                  check("layernorm_fwd rstd", dtype, rstd2, rrstd, f32_tol))
        rows = B * T
        # device times by CUDA graph: eager times of these 0.02-0.05 ms
        # calls are Triton's launch work.  Bytes: x read, y written, w and
        # b read, mean and rstd written
        timed(results, dtype, "layernorm_fwd", err,
              lambda: layernorm_fwd_stats(x, w, b, 1e-5),
              lambda: layernorm_fwd_stats_reference(x, w, b, 1e-5),
              (2 * rows * d * isz + 2 * d * isz + 8 * rows, 8 * rows * d),
              lambda: F.layer_norm(x, (d,), w, b, 1e-5))
        gy = rnd(B * T, d)
        got = layernorm_bwd(gy, x, w, mean, rstd)
        want = layernorm_bwd_reference(gy, x, w, mean, rstd)
        err = max(check(f"layernorm_bwd {n}", dtype, a, e, tol)
                  for n, a, e in zip(("dx", "dw", "db"), got, want))
        discriminates("layernorm_bwd", dtype, want[1], tol,
                      torch.zeros_like(want[1]))
        again = layernorm_bwd(gy, x, w, mean, rstd)
        if not all(torch.equal(a, e) for a, e in zip(got, again)):
            raise AssertionError(f"layernorm_bwd {dtype}: two runs differ")
        # the library's whole backward: aten's LayerNorm backward with dx,
        # dw and db requested.  Bytes: g and x read, dx written, w read, dw
        # and db written, mean and rstd read
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [d], w, b,
                                                           1e-5)
        timed(results, dtype, "layernorm_bwd", err,
              lambda: layernorm_bwd(gy, x, w, mean, rstd),
              lambda: layernorm_bwd_reference(gy, x, w, mean, rstd),
              (3 * rows * d * isz + 3 * d * isz + 8 * rows, 10 * rows * d),
              lambda: torch.ops.aten.native_layer_norm_backward(
                  gy, x, [d], lmean, lrstd, w, b, [True, True, True]))
        # the JAX signature's input gradient alone, beside aten's dx alone
        dx = layernorm_bwd_dx(gy, w, xhat, rstd2)
        err = check("layernorm_bwd_dx dx", dtype, dx,
                    layernorm_bwd_dx_reference(gy, w, xhat, rstd2), tol)
        timed(results, dtype, "layernorm_bwd", err,
              lambda: layernorm_bwd_dx(gy, w, xhat, rstd2),
              lambda: layernorm_bwd_dx_reference(gy, w, xhat, rstd2),
              (rows * d * (2 * isz + 4) + d * isz + rows * 4, 6 * rows * d),
              lambda: torch.ops.aten.native_layer_norm_backward(
                  gy, x, [d], lmean, lrstd, w, b, [True, False, False]),
              variant="dx_")
        del lmean, lrstd, got, want, again
        del x, y, mean, rstd, xhat, rstd2, gy, dx
        torch.cuda.empty_cache()


def fused_bwd_case(results, dtype, g, B, H, S, hd, causal, timed,
                   variant=""):
    """Kernel 9 at one shape, B * H rows of S x hd: ``attention_bwd`` under
    the switch (rowsum, the fused kernel, the cast of its f32 dq) against
    the fused kernel's plain version, and without it (the two passes)
    against theirs (:func:`bwd_reference`), each by :func:`check_ulp` with
    the other causal mask's output among those it must refuse;
    bit-identical on a rerun.  ``timed``: the fused kernel beside its plain
    version, its bound and SDPA's backward (by CUDA graph), and
    ``attention_bwd`` both ways; with a ``variant``, also the two passes,
    recorded under it."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_dkv, attention_bwd_dq,
        attention_bwd_fused, attention_bwd_fused_reference,
        attention_fwd_res, fused_rows, set_flash_fused)

    tol = KERNEL_TOL[dtype]
    isz = torch.tensor([], dtype=dtype).element_size()
    bh, sc = B * H, hd ** -0.5
    q, k, v, do = (torch.randn((bh, S, hd), generator=g,
                               device=g.device).to(dtype) for _ in range(4))
    out, lse = attention_fwd_res(q, k, v, sc, causal)
    dcap = (do.float() * out.float()).sum(-1).contiguous()

    def both_ways():
        prev = set_flash_fused(True)
        try:
            return attention_bwd(do, q, k, v, sc, causal, out=out, lse=lse)
        finally:
            set_flash_fused(prev)

    got, again = both_ways(), both_ways()
    two = attention_bwd(do, q, k, v, sc, causal, out=out, lse=lse)
    # bf16: one reference for both (no dcap refinement in either); f32: the
    # fused kernel's plain version evaluated in f64 from the same lse and
    # dcap (its f32 evaluation errs against f64 by about the tolerance
    # times the rms, as the recompute backward's does: bwd_reference), and
    # the recompute backward in f64
    want, allow = bwd_reference(dtype, do, q, k, v, out, lse, sc, causal)
    fused_want = want if dtype == torch.bfloat16 else \
        attention_bwd_fused_reference(
            *(t.double() for t in (do, q, k, v)), out, lse.double(),
            dcap.double(), sc, causal)
    # what a kernel with the mask dropped (or added) returns
    wrong = attention_bwd_fused_reference(do, q, k, v, out, lse, dcap, sc,
                                          not causal)
    tag = f"attention_bwd_fused ({bh}, {S}, {hd}) causal={causal}"
    names = ("dq", "dk", "dv")
    errs = [check_ulp(f"{tag} {n}", dtype, a, w, tol, z, torch.zeros_like(w),
                      allow=al)
            for n, a, w, z, al in zip(names, got, fused_want, wrong, allow)]
    two_errs = [check_ulp(f"{tag} two passes {n}", dtype, a, w, tol, z,
                          allow=al)
                for n, a, w, z, al in zip(names, two, want, wrong, allow)]
    del fused_want, allow
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: two calls differ")
    del got, again, two, want, wrong
    torch.cuda.empty_cache()
    record(results, dtype, "attention_bwd_fused", max(errs))
    record(results, dtype, "attention_bwd_dq", two_errs[0])
    record(results, dtype, "attention_bwd_dkv", max(two_errs[1:]))
    nk = -(-S // fused_rows(hd, dtype))
    log(f"  {tag}: two calls bit-identical; dq summed in the kernel over "
        f"{nk} key blocks of {fused_rows(hd, dtype)} rows into one f32 "
        f"buffer of {bh * S * hd * 4 / 1e6:.1f} MB (the TPU kernel's slabs: "
        f"{nk * bh * S * hd * 4 / 1e9:.3f} GB)")
    if not timed:
        return
    # the function's own bytes: q, k, v, dO, lse and dcap read, dq, dk and
    # dv written; its operations: s, dp, dv, dk and dq, 2 hd each per pair
    pairs = bh * S * (S + 1) / 2 if causal else bh * S * S
    tile, rows = bh * S * hd * isz, bh * S * 4

    def library_bwd():
        # dq, dk and dv in one call, beside the fused kernel and both
        # passes: by CUDA graph, its eager time logged
        q4, k4, v4, do4 = (t.reshape(B, H, S, hd) for t in (q, k, v, do))
        ts = [t.detach().requires_grad_() for t in (q4, k4, v4)]
        o = F.scaled_dot_product_attention(*ts, is_causal=causal)
        eager = cuda_ms(lambda: torch.autograd.grad(o, ts, do4,
                                                    retain_graph=True), 5)
        log(f"  attention_bwd SDPA {variant}{str(dtype)[6:]}: {eager:.4f} "
            f"ms eager")
        del o, ts
        return sdpa_bwd_ms(q4, k4, v4, do4, is_causal=causal)

    lib_ms = library_time(f"attention_bwd {variant}", dtype, library_bwd)
    fused_fn = lambda: attention_bwd_fused(do, q, k, v, lse, dcap, sc, causal)
    cost, peak = flash_cost(dtype, 7 * tile + 2 * rows, 10 * hd * pairs)
    record(results, dtype, "attention_bwd_fused", max(errs),
           cuda_ms(fused_fn),
           cuda_ms(lambda: attention_bwd_fused_reference(
               do, q, k, v, out, lse, dcap, sc, causal), 2),
           cost=cost, library_ms=lib_ms, variant=variant,
           graph=graph_ms(fused_fn, 10), peak=peak)
    if variant:
        # the two passes on the same inputs, like for like
        plain_ms = cuda_ms(lambda: bwd_plain(
            dtype, do, q, k, v, out, lse, sc, causal), 2)
        dq_fn = lambda: attention_bwd_dq(do, q, k, v, lse, dcap, sc, causal)
        dkv_fn = lambda: attention_bwd_dkv(do, q, k, v, lse, dcap, sc,
                                           causal)
        cost, peak = flash_cost(dtype, 5 * tile + 2 * rows, 6 * hd * pairs)
        record(results, dtype, "attention_bwd_dq", two_errs[0],
               cuda_ms(dq_fn), plain_ms, cost=cost, library_ms=lib_ms,
               variant=variant, graph=graph_ms(dq_fn, 10), peak=peak)
        cost, peak = flash_cost(dtype, 6 * tile + 2 * rows, 8 * hd * pairs)
        record(results, dtype, "attention_bwd_dkv", max(two_errs[1:]),
               cuda_ms(dkv_fn), plain_ms, cost=cost, library_ms=lib_ms,
               variant=variant, graph=graph_ms(dkv_fn, 10), peak=peak)
    fused_ms = cuda_ms(both_ways)
    two_ms = cuda_ms(lambda: attention_bwd(do, q, k, v, sc, causal, out=out,
                                           lse=lse))
    log(f"  attention_bwd {variant[:-1]} {str(dtype)[6:]} ({bh}, {S}, {hd}) "
        f"causal={causal}: rowsum + fused kernel + dq cast {fused_ms:.4f} "
        f"ms, rowsum + two passes {two_ms:.4f} ms")
    del q, k, v, do, out, lse, dcap
    torch.cuda.empty_cache()


def phase_flash_kernels(results):
    """Phase 3, the rest of the flash surface: the flash kernels with
    per-row lengths at BERT-base's attention shape (G 1 and 2, causal and
    not; padded rows exactly 0), the fused backward at GPT-2's training
    shape (:func:`fused_bwd_case`), and flash_block at the chunk shape with
    a nonzero lse cotangent."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.autograd import flash_block
    from lightgrad_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_dkv, attention_bwd_dq, attention_fwd_res,
        attention_fwd_reference, flash_block_bwd, flash_block_fwd,
        flash_block_reference)

    dev, f32 = torch.device("cuda"), torch.float32
    g = torch.Generator(device=dev).manual_seed(8)
    H = BERT_BASE["num_attention_heads"]
    B, S, hd = BERT_BATCH, BERT_SEQ, BERT_BASE["hidden_size"] // H
    bh, sc = B * H, hd ** -0.5
    # bert_batch's lengths (its rng's first draw, 64-128), one made full
    lengths = np.random.default_rng(0).integers(S // 2, S + 1, size=B)
    lengths[0] = S
    lens = torch.as_tensor(lengths, device=dev,
                           dtype=torch.int32).repeat_interleave(H)
    pad = torch.arange(S, device=dev)[None, :] >= lens[:, None]
    # valid (query, key) pairs of each row block, and the share of (B*H, S)
    # rows that are valid: what these lengths need of the inputs
    L = lens.double()
    pairs = {False: float((L * L).sum()), True: float((L * (L + 1) / 2).sum())}
    valid = float(L.sum()) / (bh * S)
    TB, T = TRAIN_BATCH * GPT2_SMALL["n_head"], GPT2_SMALL["n_positions"]
    C = T // CHUNKS
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]
        isz = torch.tensor([], dtype=dtype).element_size()

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        # lengths: BERT's self-attention through attention_lengths
        for G, causal in ((1, False), (1, True), (2, False), (2, True)):
            q, do = rnd(bh, S, hd), rnd(bh, S, hd)
            k, v = rnd(bh // G, S, hd), rnd(bh // G, S, hd)
            out, lse = attention_fwd_res(q, k, v, sc, causal, lengths=lens)
            got = attention_bwd(do, q, k, v, sc, causal, out=out, lse=lse,
                                lengths=lens)
            ro, rl = attention_fwd_reference(q, k, v, sc, causal, lens)
            want, allow = bwd_reference(dtype, do, q, k, v, out, lse, sc,
                                        causal, lens)
            tag = f"lengths ({bh}, {S}, {hd}) G={G} causal={causal}"
            err = check_fwd(f"attention_fwd {tag} out", dtype, out, ro,
                            torch.zeros_like(ro))
            check(f"attention_fwd {tag} lse", dtype, lse, rl,
                  KERNEL_TOL[f32])
            errs = [check_bwd(f"attention_bwd {tag} {n}", dtype, a, w, tol,
                              allow=al)
                    for n, a, w, al in zip(("dq", "dk", "dv"), got, want,
                                           allow)]
            for w in (ro, *want):
                discriminates("flash lengths", dtype, w, tol,
                              torch.zeros_like(w))
            zero = [out[pad], lse[..., 0][pad], got[0][pad]]
            if G == 1:
                zero += [got[1][pad], got[2][pad]]
            if any(bool((z != 0).any()) for z in zero):
                raise AssertionError(f"{tag}: a padded row is not 0")
            record(results, dtype, "attention_fwd", err)
            record(results, dtype, "attention_bwd_dq", errs[0])
            record(results, dtype, "attention_bwd_dkv", max(errs[1:]))
            if G == 2 or causal:
                continue
            # times of BERT's call: G 1, not causal.  Bounds: the valid rows
            # of every input are read, the outputs written in full (padded
            # rows as zeros)
            tile, n = bh * S * hd * isz, pairs[False]
            rows = bh * S * 4                   # one f32 (B*H, S) row set
            q4, k4, v4 = (t.reshape(B, H, S, hd) for t in (q, k, v))
            keep = ~pad.reshape(B, H, 1, S)[:, :1]
            cost, peak = flash_cost(
                dtype, 3 * valid * tile + tile + rows + bh * 4, 4 * hd * n)
            record(results, dtype, "attention_fwd", err,
                   cuda_ms(lambda: attention_fwd_res(q, k, v, sc, False,
                                                     lengths=lens)),
                   cuda_ms(lambda: attention_fwd_reference(q, k, v, sc,
                                                           False, lens)),
                   cost=cost, peak=peak, library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       q4, k4, v4, attn_mask=keep)), variant="lengths_")
            dcap = (do.float() * out.float()).sum(-1).contiguous()
            plain_ms = cuda_ms(lambda: bwd_plain(
                dtype, do, q, k, v, out, lse, sc, False, lens), 5)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
            og = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do.reshape(B, H, S, hd),
                retain_graph=True), 5)
            cost, peak = flash_cost(dtype, valid * (4 * tile + 2 * rows)
                                   + tile + bh * 4, 6 * hd * n)
            record(results, dtype, "attention_bwd_dq", errs[0],
                   cuda_ms(lambda: attention_bwd_dq(do, q, k, v, lse, dcap,
                                                    sc, False, lens)),
                   plain_ms, cost=cost, library_ms=lib_ms,
                   variant="lengths_", peak=peak)
            cost, peak = flash_cost(dtype, valid * (4 * tile + 2 * rows)
                                   + 2 * tile + bh * 4, 8 * hd * n)
            record(results, dtype, "attention_bwd_dkv", max(errs[1:]),
                   cuda_ms(lambda: attention_bwd_dkv(do, q, k, v, lse, dcap,
                                                     sc, False, lens)),
                   plain_ms, cost=cost, library_ms=lib_ms,
                   variant="lengths_", peak=peak)
            del qg, kg, vg, og
        torch.cuda.empty_cache()

        # the call shape of the TPU kernel's two-heads-a-step variant
        # (_fwd_kernel_pair: G 1, no lengths, no window, not causal, d <=
        # 64, an even B), which the same kernel serves: BERT-base's heads
        q, k, v = rnd(bh, S, hd), rnd(bh, S, hd), rnd(bh, S, hd)
        out, lse = attention_fwd_res(q, k, v, sc, False)
        ro, rl = attention_fwd_reference(q, k, v, sc, False)
        err = check_fwd(f"attention_fwd pair ({bh}, {S}, {hd}) out", dtype,
                        out, ro, torch.zeros_like(ro),
                        attention_fwd_reference(q, k, v, sc, True)[0])
        check(f"attention_fwd pair ({bh}, {S}, {hd}) lse", dtype, lse, rl,
              KERNEL_TOL[f32])
        q4, k4, v4 = (t.reshape(B, H, S, hd) for t in (q, k, v))
        tile = bh * S * hd * isz
        cost, peak = flash_cost(dtype, 4 * tile + bh * S * 4,
                                4 * bh * S * S * hd)
        record(results, dtype, "attention_fwd", err,
               cuda_ms(lambda: attention_fwd_res(q, k, v, sc, False)),
               cuda_ms(lambda: attention_fwd_reference(q, k, v, sc, False)),
               cost=cost, peak=peak, library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4)), variant="pair_")
        del q, k, v, out, lse, ro, rl, q4, k4, v4
        torch.cuda.empty_cache()

        # the fused backward at GPT-2's training shape, causal
        fused_bwd_case(results, dtype, g, TRAIN_BATCH, GPT2_SMALL["n_head"],
                       T, GPT2_SMALL["n_embd"] // GPT2_SMALL["n_head"], True,
                       True)

        # flash_block at the chunk shape, lse cotangent nonzero
        q, k, v = (rnd(TB, C, hd) for _ in range(3))
        w = torch.randn(TB, C, hd, generator=g, device=dev)
        wl = torch.randn(TB, C, 1, generator=g, device=dev)

        def run(fn, causal):
            ts = [t.clone().requires_grad_() for t in (q, k, v)]
            o, l = fn(*ts, sc, causal)
            ((o.float() * w).sum() + (l * wl).sum()).backward()
            return [o, l] + [t.grad for t in ts]

        err = 0.0
        for causal in (True, False):
            got, want = run(flash_block, causal), \
                run(flash_block_reference, causal)
            for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
                err = max(err, check(
                    f"flash_block ({TB}, {C}, {hd}) causal={causal} {n}",
                    dtype, a, b, KERNEL_TOL[f32] if n == "lse" else tol))
                if n != "lse":
                    discriminates("flash_block", dtype, b, tol,
                                  torch.zeros_like(b))
        # times: a ring round off the diagonal (not causal), forward (out,
        # lse) beside the library's lse-returning attention; the backward
        # (dlse != 0) beside torch autograd of the plain version
        q4, k4, v4 = (t.reshape(TRAIN_BATCH, -1, C, hd) for t in (q, k, v))
        try:
            torch.ops.aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, None, True)
            lib_ms = cuda_ms(lambda: torch.ops.aten.
                             _scaled_dot_product_efficient_attention(
                                 q4, k4, v4, None, True))
        except RuntimeError as e:
            lib_ms = None
            log(f"  flash_block {str(dtype)[6:]}: no library time, the "
                f"efficient-attention op refused the call: "
                f"{str(e).splitlines()[0][:160]}")
        tile = TB * C * hd * isz
        cost, peak = flash_cost(dtype, 4 * tile + TB * C * 4,
                                4 * TB * C * C * hd)
        record(results, dtype, "flash_block", err,
               cuda_ms(lambda: flash_block_fwd(q, k, v, sc, False)),
               cuda_ms(lambda: flash_block_reference(q, k, v, sc, False)),
               cost=cost, library_ms=lib_ms, peak=peak)
        out, lse = flash_block_fwd(q, k, v, sc, False)
        gout, glse = w.to(dtype), wl
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        ro, rl = flash_block_reference(*ts, sc, False)

        def bwd():
            return flash_block_bwd(gout, glse, q, k, v, out, lse, sc, False)

        # its backward is the two passes: their bound, three tf32 passes
        # in f32
        cost, peak = flash_cost(dtype, 8 * tile + 2 * TB * C * 4,
                               10 * TB * C * C * hd)
        record(results, dtype, "flash_block", err, cuda_ms(bwd),
               cuda_ms(lambda: torch.autograd.grad(
                   (ro, rl), ts, (gout, glse), retain_graph=True), 5),
               cost=cost, library_ms=None, variant="bwd_",
               graph=graph_ms(bwd), peak=peak)
        del q, k, v, w, wl, out, lse, ts, ro, rl, q4, k4, v4
        torch.cuda.empty_cache()


def phase_train(dtype, card, fused=False):
    """Phase 5 for one configuration: float32 + Adam or bfloat16
    MixedPrecision + AdamW, with ``fused`` the fused flash backward
    (``set_flash_fused(True)`` for the steps); 5 steps on one batch
    of random tokens.  Returns the kernels' launch counts of the 5 steps,
    tokens/s and peak memory."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch import GPT, GPTConfig, amp, optim
    from lightgrad_tpu_torch.loss import cross_entropy
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightgrad_tpu_torch.ops.attention import set_flash_fused

    dev = torch.device("cuda")
    cfg = GPTConfig(**GPT2_SMALL)
    B, T, V = TRAIN_BATCH, cfg.n_positions, cfg.vocab_size
    model = GPT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    if dtype == torch.float32:
        opt = optim.Adam(model.parameters(), lr=TRAIN_LR)
        zero_grad, update = opt.zero_grad, opt.step
    else:
        mp = amp.MixedPrecision(
            model, lambda ps: optim.AdamW(ps, lr=TRAIN_LR), dtype)
        zero_grad, update = mp.zero_grad, mp.step
    params = dict(model.named_parameters())
    g = torch.Generator(device=dev).manual_seed(11)
    ids = torch.randint(0, V, (B, T), generator=g, device=dev)
    tgt = torch.randint(0, V, (B * T,), generator=g, device=dev)

    # the plain step on the same weights: reference ops, torch autograd
    plain_loss = F.cross_entropy(plain_forward(model, ids).float()
                                 .reshape(B * T, V), tgt)
    plain_grads = torch.autograd.grad(plain_loss, list(params.values()))
    plain_grads = dict(zip(params, plain_grads))
    del plain_loss
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    prev = set_flash_fused(fused)
    try:
        for step in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(ids)
            loss = cross_entropy(logits.reshape(B * T, V), tgt)
            zero_grad()
            loss.backward()
            if step == 0:               # the check's time is not the step's
                torch.cuda.synchronize()
                c0 = time.perf_counter()
                grad_check(params, plain_grads, dtype)
                del plain_grads
                t0 += time.perf_counter() - c0
            update()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss.detach()))
            del logits, loss
    finally:
        set_flash_fused(prev)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    tok_s = B * T / float(np.median(times[1:]))
    log(f"  losses: {[round(x, 4) for x in losses]} "
        f"({'finite, falling' if ok else 'FAIL'})")
    log(f"  {B}x{T} tokens a step: {tok_s:.1f} tok/s (median of steps "
        f"2-{TRAIN_STEPS}, step times {[round(t, 4) for t in times]} s); "
        f"peak memory {peak / 2**30:.2f} GiB; {card}")
    if not ok:
        raise AssertionError(f"training loss not finite and falling: "
                             f"{losses}")
    return counts, tok_s, peak


def chunked_attention(q, k, v, scale, n, block):
    """Causal attention of (B, S, D) q, k, v as ring attention computes it,
    in one process: query chunk i merges ``block`` over its diagonal chunk
    (causal) with every earlier chunk (not causal), each an (out, lse)
    pair, by the JAX package's ``_merge``.  Returns (out, lse)."""
    c = q.shape[-2] // n
    outs, lses = [], []
    for i in range(n):
        rows = slice(i * c, (i + 1) * c)
        qi = q[:, rows]
        acc, lse = block(qi, k[:, rows], v[:, rows], scale, True)
        acc = acc.float()
        for j in range(i):
            cols = slice(j * c, (j + 1) * c)
            out_r, lse_r = block(qi, k[:, cols], v[:, cols], scale, False)
            lse_new = torch.logaddexp(lse, lse_r)
            acc = (acc * torch.exp(lse - lse_new)
                   + out_r.float() * torch.exp(lse_r - lse_new))
            lse = lse_new
        outs.append(acc.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 1)


def phase_chunked(card):
    """Phase 5, chunked attention through flash_block at GPT-2 small's
    attention width (96 x 1024 x 64, causal) in float32 and bfloat16:
    CHUNKS chunks, one backward of sum(out * w) + sum(lse * wl) by torch
    autograd, held against one full flash call (forward, and the backward
    with lse's cotangent as dcap - dlse).  Returns {dtype: launch
    counts}."""
    from lightgrad_tpu_torch.autograd import flash_block
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightgrad_tpu_torch.ops.attention import (attention_fwd_res,
                                                   flash_block_bwd)

    dev = torch.device("cuda")
    TB, T = TRAIN_BATCH * GPT2_SMALL["n_head"], GPT2_SMALL["n_positions"]
    hd = GPT2_SMALL["n_embd"] // GPT2_SMALL["n_head"]
    sc = hd ** -0.5
    g = torch.Generator(device=dev).manual_seed(13)
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]
        q, k, v = (torch.randn(TB, T, hd, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        w = torch.randn(TB, T, hd, generator=g, device=dev)
        wl = torch.randn(TB, T, 1, generator=g, device=dev)
        times = []
        for _ in range(2):          # the second run is timed
            ts = [t.clone().requires_grad_() for t in (q, k, v)]
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out, lse = chunked_attention(*ts, sc, CHUNKS, flash_block)
            ((out.float() * w).sum() + (lse * wl).sum()).backward()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts[dtype] = launch_counts()
        f_out, f_lse = attention_fwd_res(q, k, v, sc, True)
        want = flash_block_bwd(w.to(dtype), wl, q, k, v, f_out, f_lse, sc,
                               True)
        tag = f"chunked ({TB}, {T}, {hd}) causal, {CHUNKS} chunks vs one call"
        check(f"{tag} out", dtype, out, f_out, tol)
        check(f"{tag} lse", dtype, lse, f_lse, KERNEL_TOL[torch.float32])
        for n, t, b in zip(("dq", "dk", "dv"), ts, want):
            check(f"{tag} {n}", dtype, t.grad, b, tol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_out, f_lse = attention_fwd_res(q, k, v, sc, True)
        flash_block_bwd(w.to(dtype), wl, q, k, v, f_out, f_lse, sc, True)
        torch.cuda.synchronize()
        log(f"  {str(dtype)[6:]}: forward + backward {times[1] * 1e3:.2f} "
            f"ms in {CHUNKS} chunks ({CHUNKS * (CHUNKS + 1) // 2} blocks), "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms in one call; {card}")
        del q, k, v, w, wl, ts, out, lse, f_out, f_lse, want
        torch.cuda.empty_cache()
    return counts


def grad_check(params, plain_grads, dtype):
    """Step 1's kernel-path gradient of every parameter vs the plain step:
    max |err| / max |reference| within PATH_TOL."""
    worst, worst_name = 0.0, None
    for name, p in params.items():
        want = plain_grads[name].float()
        got = p.grad.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {name} is not finite")
        rel = (got - want).abs().max().item() / max(
            want.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    ok = worst <= PATH_TOL[dtype]
    log(f"  step-1 gradients of {len(params)} parameters vs the plain step: "
        f"worst rel {worst:.3e} ({worst_name}) tol {PATH_TOL[dtype]:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"gradient of {worst_name}: rel {worst}")


def phase_tape_kernels(results):
    """Phase 3, the tape's generic kernels: elementwise, reduce, matmul and
    softmax vs their plain versions at the BERT-base path's shapes (B*S =
    1024 rows, d 768, ffn 3072, vocab 30522, 96 heads of 128 x 64)."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.ops.elementwise import (_READS, ew,
                                                     ew_reference, scalar)
    from lightgrad_tpu_torch.ops.matmul import (matmul, matmul_reference,
                                                matmul_vjp)
    from lightgrad_tpu_torch.ops.reduce import reduce, reduce_reference
    from lightgrad_tpu_torch.ops.softmax import (softmax_bwd,
                                                 softmax_bwd_reference,
                                                 softmax_fwd,
                                                 softmax_fwd_reference)

    c = BERT_BASE
    B, S, d, f, V = (BERT_BATCH, BERT_SEQ, c["hidden_size"],
                     c["intermediate_size"], c["vocab_size"])
    H = c["num_attention_heads"]
    hd, R, dev = d // H, BERT_BATCH * BERT_SEQ, torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    lengths = torch.as_tensor(np.random.default_rng(0).integers(
        S // 2, S + 1, size=B), device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]
        isz = torch.tensor([], dtype=dtype).element_size()

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)

        # elementwise: GELU and its gradient, the padding mask, a fused
        # two-gradient add, a scalar multiply (by value), each against its
        # plain version; then the main paths' classes (PERF.md §6, row 1),
        # each by CUDA graph with L2 flushed beside one PyTorch call.  The
        # mask is the path's own: 0 on valid keys, -1e9 past lengths drawn
        # from 64-128.
        h, gh = rnd(R, f), rnd(R, f)
        scores = rnd(B, H, S, S, scale=2.0)
        mask = ((torch.arange(S, device=dev) >= lengths[:, None]) * -1e9
                ).reshape(B, 1, 1, S).to(dtype)
        x, y = rnd(R, d), rnd(d)
        err = 0.0
        for body, args, n_out in (
                ("f_gelu", (h,), 1), ("b_gelu", (gh, h), 1),
                ("f_add", (scores, mask), 1), ("b2_add", (x, x, y), 2),
                ("f_mul", (x, scalar(0.125, dtype)), 1)):
            got = ew(body, *args, n_out=n_out)
            want = ew_reference(body, *args, n_out=n_out)
            for i, (a, b) in enumerate(zip(*(
                    (t,) if n_out == 1 else t for t in (got, want)))):
                err = max(err, check(f"elementwise {body}[{i}] "
                                     f"{tuple(a.shape)}", dtype, a, b, tol))
        discriminates("elementwise", dtype, ew_reference("f_gelu", h), tol,
                      torch.zeros_like(h), h)
        for variant, body, n_out, make, lib in ew_classes(dtype, g):
            sets = operand_sets(make)
            outs = [ew(body, *s, n_out=n_out) for s in sets[:2]]
            want = ew_reference(body, *sets[1], n_out=n_out)
            e = 0.0
            for a, b in zip(*((t,) if n_out == 1 else t
                              for t in (outs[1], want))):
                e = max(e, check(f"elementwise {variant or 'gelu_'}{body} "
                                 f"{tuple(a.shape)}", dtype, a, b, tol))
            err = max(err, e)
            # the bound's bytes: the operands the body reads (b2_add's
            # and b2_sub's a and b only shape the output), outputs written
            reads = _READS.get(body, range(len(sets[0])))
            nbytes = sum(own_bytes(t) for j, t in enumerate(sets[0])
                         if j in reads and isinstance(t, torch.Tensor)) + sum(
                t.numel() * t.element_size() for t in
                ((outs[0],) if n_out == 1 else outs[0]))
            plain = ew_plain(body, n_out, sets[0])
            timed_sets(results, dtype, "elementwise", e,
                       lambda *s: ew(body, *s, n_out=n_out), plain,
                       (nbytes, nbytes // 4), lib, sets, variant=variant)
            del sets, outs, want
        torch.cuda.empty_cache()

        # reduce: bias gradients (column sums), the loss's row max and sum
        logits = rnd(R, V)
        err = 0.0
        for t, op, axis in ((x, "sum", 0), (h, "sum", 0),
                            (logits, "max", -1), (logits, "sum", -1)):
            err = max(err, check(f"reduce {op} {tuple(t.shape)} axis={axis}",
                                 dtype, reduce(t, op, axis=axis),
                                 reduce_reference(t, op, axis=axis), tol))
        timed(results, dtype, "reduce", err,
              lambda: reduce(logits, "sum", axis=-1),
              lambda: reduce_reference(logits, "sum", axis=-1),
              ((R * V + R) * isz, R * V), lambda: torch.sum(logits, -1))
        # the other layout classes of the main paths, sum and max, each
        # beside torch.sum / torch.amax over the same dims: a column sum at
        # GPT-2's 8192 x 768 (a bias gradient), BatchNorm's (0, 2, 3) at
        # ResNet-18's layer-1 activation (read in place, split over R), a
        # whole tensor (split over R); bytes: input read, output written
        for variant, t, axis in (
                ("", logits, -1),
                ("col_", rnd(TRAIN_BATCH * GPT2_SMALL["n_positions"],
                             GPT2_SMALL["n_embd"]), 0),
                ("bn_", rnd(32, 64, 56, 56), (0, 2, 3)),
                ("whole_", rnd(32, 64, 56, 56), None)):
            dims = tuple(range(t.dim())) if axis is None else axis
            for op, lib in (("sum", torch.sum), ("max", torch.amax)):
                if not variant and op == "sum":
                    continue            # the record's main line, above
                want = reduce_reference(t, op, axis=axis)
                err = check(f"reduce {op} {tuple(t.shape)} axis={axis}",
                            dtype, reduce(t, op, axis=axis), want, tol)
                discriminates("reduce", dtype, want, tol,
                              torch.zeros_like(want))
                timed(results, dtype, "reduce", err,
                      lambda: reduce(t, op, axis=axis),
                      lambda: reduce_reference(t, op, axis=axis),
                      ((t.numel() + want.numel()) * isz, t.numel()),
                      lambda: lib(t, dims),
                      variant=variant + ("max_" if op == "max" else ""))
            del t
        torch.cuda.empty_cache()

        # matmul: every product of the step and its gradients
        w_qkv, w_up = rnd(d, d, scale=0.03), rnd(f, d, scale=0.03)
        w_dn, w_dec = rnd(d, f, scale=0.02), rnd(V, d, scale=0.03)
        x3 = x.reshape(B, S, d)
        q = rnd(B, S, d).reshape(B, S, H, hd).transpose(1, 2)
        k = rnd(B, S, d).reshape(B, S, H, hd).transpose(1, 2)
        p = torch.softmax(scores.float(), -1).to(dtype)
        err = 0.0
        for name, a, b in (("x @ Wqkv.T", x3, w_qkv.T),
                           ("x @ Wup.T", x3, w_up.T),
                           ("h @ Wdown.T", h, w_dn.T),
                           ("x @ Wdec.T", x, w_dec.T),
                           ("q @ k^T", q, k.transpose(-1, -2)),
                           ("p @ v", p, k)):
            err = max(err, check(f"matmul {name}", dtype, matmul(a, b),
                                 matmul_reference(a, b), tol))
        gy = rnd(R, V, scale=0.1)
        ga, gb = matmul_vjp(gy, x, w_dec.T)
        err = max(err, check("matmul vjp dx (decoder)", dtype, ga,
                             matmul_reference(gy, w_dec), tol),
                  check("matmul vjp dW.T (decoder)", dtype, gb,
                        matmul_reference(x.T, gy), tol))
        record(results, dtype, "matmul", err)
        del logits, w_dec, gy, ga, gb
        if dtype == torch.float32:
            # the three tf32 passes reach f32 accuracy: against the f64
            # product within 4x cuBLAS f32's own error (TF32 off; at least
            # 4 ulps of the product's scale), a bar that one tf32 pass
            # (cuBLAS with TF32 on) fails
            a, b = rnd(R, d), rnd(f, d, scale=0.03).T
            want = torch.matmul(a.double(), b.double())

            def f64_err(t):
                return ((t.double() - want).abs().max()
                        / want.abs().max()).item()
            got, lib = f64_err(matmul(a, b)), f64_err(torch.matmul(a, b))
            torch.backends.cuda.matmul.allow_tf32 = True
            one = f64_err(torch.matmul(a, b))
            torch.backends.cuda.matmul.allow_tf32 = False
            bar = max(4 * lib, 4 * 2.0 ** -23)
            ok = got <= bar < one
            log(f"  matmul f32 vs float64 ({R} x {d} @ {d} x {f}): kernel "
                f"{got:.3e}, cuBLAS f32 {lib:.3e}, cuBLAS TF32 {one:.3e} "
                f"(bar {bar:.3e}: {'ok' if ok else 'FAIL'})")
            if not ok:
                raise AssertionError(f"matmul f32: {got} against 4 x {lib} "
                                     f"(TF32 {one})")
            del a, b, want
        # device time by CUDA graph at the tape's shapes (MATMUL_SHAPES);
        # the f32 bound counts three tf32 passes at TF32_OPS
        for variant, M_, N_, K_, a_t, b_t in MATMUL_SHAPES:
            a = rnd(*((K_, M_) if a_t else (M_, K_)))
            b = rnd(*((N_, K_) if b_t else (K_, N_)), scale=K_ ** -0.5)
            a, b = (a.T if a_t else a), (b.T if b_t else b)
            err = check(f"matmul {M_} x {K_} @ {K_} x {N_}"
                        f"{' (A read along m)' if a_t else ''}", dtype,
                        matmul(a, b), matmul_reference(a, b), tol)
            ops = 2 * M_ * N_ * K_
            timed(results, dtype, "matmul", err, lambda: matmul(a, b),
                  lambda: matmul_reference(a, b),
                  ((M_ * K_ + K_ * N_ + M_ * N_) * isz,
                   ops if dtype == torch.bfloat16 else 3 * ops),
                  lambda: torch.matmul(a, b), 10, variant=variant,
                  peak=None if dtype == torch.bfloat16 else TF32_OPS)
            del a, b
            torch.cuda.empty_cache()

        # softmax of the masked scores and its gradient
        sm = scores + mask
        ys, want = softmax_fwd(sm), softmax_fwd_reference(sm)
        err = check(f"softmax_fwd {tuple(sm.shape)}", dtype, ys, want, tol)
        one_hot = torch.zeros_like(want).scatter_(-1, want.argmax(-1, True),
                                                  1.0)
        discriminates("softmax_fwd", dtype, want, tol,
                      torch.zeros_like(want), one_hot)
        sets = operand_sets(lambda: (rnd(B, H, S, S, scale=2.0) + mask,))
        timed_sets(results, dtype, "softmax_fwd", err, softmax_fwd,
                   softmax_fwd_reference,
                   (2 * sm.numel() * isz, 5 * sm.numel()),
                   lambda t: torch.softmax(t, -1), sets)
        del sets
        gs = rnd(B, H, S, S)
        want = softmax_bwd_reference(gs, ys)
        err = check(f"softmax_bwd {tuple(gs.shape)}", dtype,
                    softmax_bwd(gs, ys), want, tol)
        discriminates("softmax_bwd", dtype, want, tol, torch.zeros_like(want))
        sets = operand_sets(lambda: (rnd(B, H, S, S),
                                     softmax_fwd(rnd(B, H, S, S) + mask)))
        timed_sets(results, dtype, "softmax_bwd", err, softmax_bwd,
                   softmax_bwd_reference,
                   (3 * gs.numel() * isz, 4 * gs.numel()),
                   lambda a, b: torch._softmax_backward_data(a, b, -1, dtype),
                   sets)
        del sets
        torch.cuda.empty_cache()


def phase_conv_kernels(results):
    """Phase 3, the conv kernels: forward, input gradient and weight
    gradient vs their plain versions at ResNet-18's 11 shapes (batch 32)
    and ResNet-20's 6 wider ones on the digits path (batch 128), all on
    the tensor-core route, and on grouped, dilated, 1-D, 3-D and narrow
    cases (both routes), in f32 and bf16, each on the route conv_route
    gives it; a repeat of each gradient bit for bit; the staging against
    its plain version.  Times by CUDA graph (the wrapper's whole call,
    staging included) at layer 1's shape beside cuDNN (TF32 off), the
    CUDA-core route at ResNet-20's 16-channel layer on the digits path,
    the staging on layer 1's x beside torch's channels_last copy."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from lightgrad_tpu_torch.ops.conv import (conv_bwd_dw,
                                              conv_bwd_dw_reference,
                                              conv_bwd_dx,
                                              conv_bwd_dx_reference,
                                              conv_fwd, conv_fwd_reference,
                                              conv_layout,
                                              conv_layout_reference,
                                              conv_route)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    tc_convs = RESNET18_CONVS + RESNET20_TC_CONVS
    cases = [(n, x, w, st, 1, 1) for n, x, w, st in tc_convs] \
        + list(CONV_ODD_CASES)
    tc_names = {c[0] for c in tc_convs}
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]
        isz = torch.tensor([], dtype=dtype).element_size()

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)

        def operands(xs, ws):
            # fan-in scaled weights: outputs of order 1
            fan_in = ws[1] * int(np.prod(ws[2:]))
            return rnd(*xs), rnd(*ws, scale=fan_in ** -0.5)

        err = {}
        for name, xs, ws, st, dl, grp in cases:
            route = conv_route(xs, ws, grp, dtype)
            if name in tc_names and route != "tc":
                raise AssertionError(f"{name}: a ResNet conv on {route}")
            sfx = "" if route == "tc" else "_simt"
            x, w = operands(xs, ws)
            checks = []
            want = conv_fwd_reference(x, w, st, dl, grp)
            checks.append(("conv_fwd", conv_fwd(x, w, st, dl, grp), want))
            gy = rnd(*want.shape)
            gx = conv_bwd_dx(gy, w, x.shape, st, dl, grp)
            gw = conv_bwd_dw(gy, x, w.shape, st, dl, grp)
            if not (torch.equal(gx, conv_bwd_dx(gy, w, x.shape, st, dl, grp))
                    and torch.equal(gw, conv_bwd_dw(gy, x, w.shape, st, dl,
                                                    grp))):
                raise AssertionError(f"{name} {dtype}: a repeated gradient "
                                     f"differs")
            checks.append(("conv_bwd_dx", gx, conv_bwd_dx_reference(
                gy, w, x.shape, st, dl, grp)))
            checks.append(("conv_bwd_dw", gw, conv_bwd_dw_reference(
                gy, x, w.shape, st, dl, grp)))
            for kernel, got, want in checks:
                kernel += sfx
                err[kernel] = max(err.get(kernel, 0.0), check(
                    f"{kernel} {name} x{tuple(xs)}", dtype, got, want, tol))
                discriminates(kernel, dtype, want, tol, torch.zeros_like(want))
            del x, w, gy, gx, gw, checks, got, want
            torch.cuda.empty_cache()

        def conv_times(sfx, xs, ws, st, tc):
            """Graph times of the three kernels of one route at (xs, ws)
            beside the plain versions and cuDNN; the f32 tensor-core bound
            counts three tf32 passes at TF32_OPS."""
            x, w = operands(xs, ws)
            y = conv_fwd(x, w, st)
            gy = rnd(*y.shape)
            ops = 2 * y.numel() * int(np.prod(ws[1:]))
            nbytes = (x.numel() + w.numel() + y.numel()) * isz
            f32tc = tc and dtype == torch.float32
            cost = (nbytes, 3 * ops if f32tc else ops)
            peak = TF32_OPS if f32tc else None
            for kernel, fn, plain, lib in (
                    ("conv_fwd", lambda: conv_fwd(x, w, st),
                     lambda: conv_fwd_reference(x, w, st),
                     lambda: F.conv2d(x, w, stride=st)),
                    ("conv_bwd_dx", lambda: conv_bwd_dx(gy, w, x.shape, st),
                     lambda: conv_bwd_dx_reference(gy, w, x.shape, st),
                     lambda: conv2d_input(x.shape, w, gy, stride=st)),
                    ("conv_bwd_dw", lambda: conv_bwd_dw(gy, x, w.shape, st),
                     lambda: conv_bwd_dw_reference(gy, x, w.shape, st),
                     lambda: conv2d_weight(x, w.shape, gy, stride=st))):
                timed(results, dtype, kernel + sfx, err[kernel + sfx], fn,
                      plain, cost, lib, 10, peak=peak)
            del x, w, y, gy
            torch.cuda.empty_cache()

        _, xs, ws, st = RESNET18_CONVS[1]
        conv_times("", xs, ws, st, True)
        _, xs, ws, st, _, _ = SIMT_TIMED
        conv_times("_simt", xs, ws, st, False)

        # the staging: layer 1's x channels-last, then the weights' reorders
        _, xs, ws, _ = RESNET18_CONVS[1]
        x = rnd(*xs)
        shape = (xs[0], xs[1], int(np.prod(xs[2:])), xs[1])
        got = conv_layout(x, *shape)
        ok = torch.equal(got, conv_layout_reference(x, *shape))
        # the forward's (Cout, Cg, KK) -> (Cout, KK, Cp), the stem's with
        # its channels padded to one 16-byte chunk, the input gradient's
        # (G, Og, Cg KK) -> (G, Cg KK, Og)
        for ts, view in ((ws, (ws[0], ws[1], 9, ws[1])),
                         ((64, 3, 7, 7), (64, 3, 49, 16 // isz)),
                         ((128, 64, 3, 3), (1, 128, 576, 128))):
            t = rnd(*ts)
            ok = ok and torch.equal(conv_layout(t, *view),
                                    conv_layout_reference(t, *view))
        if dtype == torch.float32:     # the tf32 parts the f32 kernels take
            ok = ok and all(torch.equal(a, b) for a, b in zip(
                conv_layout(x, *shape, split=True),
                conv_layout_reference(x, *shape, split=True)))
        log(f"  conv_layout {str(dtype)[6:]}: x {tuple(xs)} channels-last "
            f"(f32: and its tf32 parts) and three weight reorders "
            f"{'equal' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError(f"conv_layout {dtype}: differs from its "
                                 f"plain version")
        xcl = x.contiguous(memory_format=torch.channels_last)
        if not torch.equal(got.reshape(xs[0], *xs[2:], xs[1]),
                           xcl.permute(0, 2, 3, 1)):
            raise AssertionError("conv_layout: not torch's channels_last")
        timed(results, dtype, "conv_layout", 0.0,
              lambda: conv_layout(x, *shape),
              lambda: conv_layout_reference(x, *shape),
              (2 * x.numel() * isz, 0),
              lambda: x.contiguous(memory_format=torch.channels_last))
        del x, got, xcl
        torch.cuda.empty_cache()


def bert_batch(cfg):
    """8 x 128 random tokens; valid lengths from 64-128 (a padding mask);
    masked-LM labels on 15% of the valid positions, -100 elsewhere."""
    rng = np.random.default_rng(0)
    B, S, V = BERT_BATCH, BERT_SEQ, cfg.vocab_size
    lengths = rng.integers(S // 2, S + 1, size=B)
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    labels = np.full((B, S), -100, np.int32)
    for b in range(B):
        pick = rng.choice(lengths[b], int(0.15 * lengths[b]), replace=False)
        labels[b, pick] = rng.integers(0, V, pick.size)
    return ids, mask, labels.reshape(-1), lengths


class _PlainSoftmax(torch.autograd.Function):
    """Softmax for the plain twin: the kernels' plain versions in both
    directions (torch's own softmax backward takes its row sum in one pass,
    which loses the keys' gradient at this depth; see ops/softmax.py)."""

    @staticmethod
    def forward(ctx, x):
        from lightgrad_tpu_torch.ops.softmax import softmax_fwd_reference

        y = softmax_fwd_reference(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        from lightgrad_tpu_torch.ops.softmax import softmax_bwd_reference

        (y,) = ctx.saved_tensors
        return softmax_bwd_reference(g, y)


def plain_bert(p, cfg, ids, mask):
    """BertForMaskedLM's logits through the plain PyTorch versions of the
    kernels (``_reference``), differentiable by torch autograd: the twin
    the tape's step must meet."""
    from lightgrad_tpu_torch.ops.elementwise import ew_reference
    from lightgrad_tpu_torch.ops.layernorm import layernorm_fwd_reference
    from lightgrad_tpu_torch.ops.matmul import matmul_reference

    B, S = ids.shape
    d, H = cfg.hidden_size, cfg.num_attention_heads
    hd = d // H

    def ln(x, pre):
        return layernorm_fwd_reference(x, p[pre + ".weight"],
                                       p[pre + ".bias"],
                                       cfg.layer_norm_eps)[0]

    def lin(x, pre):
        return matmul_reference(x, p[pre + ".weight"].T) + p[pre + ".bias"]

    def heads(x):
        return x.reshape(B, S, H, hd).transpose(1, 2)

    e = "bert.embeddings."
    x = (p[e + "word_embeddings.weight"][ids]
         + p[e + "position_embeddings.weight"][:S]
         + p[e + "token_type_embeddings.weight"][0])
    x = ln(x, e + "LayerNorm")
    add_mask = ((1.0 - mask) * -1e9).reshape(B, 1, 1, S)
    for layer in range(cfg.num_hidden_layers):
        pre = f"bert.layer.{layer}."
        sa = pre + "attention.self."
        q, k, v = (heads(lin(x, sa + n)) for n in ("query", "key", "value"))
        scores = matmul_reference(q, k.transpose(-1, -2)) * hd ** -0.5
        probs = _PlainSoftmax.apply(scores + add_mask)
        ctx = matmul_reference(probs, v).transpose(1, 2).reshape(B, S, d)
        a = ln(lin(ctx, pre + "attention.dense") + x,
               pre + "attention.LayerNorm")
        h = ew_reference("f_gelu", lin(a, pre + "intermediate"))
        x = ln(lin(h, pre + "output") + a, pre + "LayerNorm")
    x = ln(ew_reference("f_gelu", lin(x, "transform")), "transform_ln")
    return lin(x, "decoder")


def tape_grad_check(model, grads32, grads64=None):
    """Step 1's tape gradient of every parameter vs the plain twin, in
    float32 (the tape's precision) and, where given, in float64: max |tape
    - twin| / max |twin| within PATH_TOL for each parameter and each twin.
    An attention's key projection bias (BERT's, ViT's) has a zero gradient
    in exact arithmetic (softmax ignores a per-row constant), so its error
    is taken relative to the same layer's query bias gradient."""
    tol = PATH_TOL[torch.float32]
    twins = {32: grads32, 64: grads64}
    twins = {bits: g for bits, g in twins.items() if g is not None}
    rel = {bits: {} for bits in twins}
    for name, t in model.named_parameters():
        got = t.grad.data.double()
        if not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {name} is not finite")
        ref_name = name.replace(".key.bias", ".query.bias")
        for bits, grads in twins.items():
            ref = max(grads[ref_name].double().abs().max().item(), 1e-30)
            rel[bits][name] = (got - grads[name].double()).abs().max().item() \
                / ref
    bad = sorted(n for bits in rel for n in rel[bits] if rel[bits][n] > tol)
    worst = {bits: max(r, key=r.get) for bits, r in rel.items()}
    log(f"  step-1 gradients of {len(rel[32])} parameters: worst rel "
        + ", ".join(f"vs the f{bits} twin {rel[bits][w]:.3e} ({w})"
                    for bits, w in worst.items())
        + f"; tol {tol:.0e} {'ok' if not bad else 'FAIL'}")
    if bad:
        raise AssertionError(f"gradients beyond tolerance: {bad}")


def tape_step(model, opt, x_ids, y, **inputs):
    """One training step of a language model on the tape (labels -100
    ignored); ``inputs`` gives BERT's ``attention_mask`` or
    ``attention_lengths``."""
    from lightgrad_tpu_torch import loss as lg_loss

    logits = model(x_ids, **inputs)
    loss = lg_loss.cross_entropy(logits.reshape(-1, logits.shape[-1]), y,
                                 ignore_index=-100)
    opt.zero_grad()
    loss.backward()
    opt.step()


# kernel-name fragment -> the family a step's device time is summed under
KERNEL_FAMILIES = (("matmul_tc_kernel", "matmul"),
                   ("ew_kernel", "elementwise"),
                   ("lg_reduce_", "reduce"), ("softmax_", "softmax"),
                   ("ln_", "layernorm"),
                   # the fused flash backward: flash_bwd_dkv_*_kernel<D, true>
                   ("true>(", "fused flash backward"),
                   ("flash", "attention"),
                   ("layout_", "conv layout"), ("conv_", "conv"),
                   ("sum_partials", "conv"), ("sum_dw", "conv"),
                   # ATen's gathers and their accumulating scatters
                   ("index", "gather / scatter"))


def step_breakdown(step, step_s, host_s):
    """Where one tape step's time goes: the tape's ops a step (counted by
    the tape's own profiler), the host time that queues forward + backward
    per op, and the device time of each kernel family in one step traced by
    torch.profiler, with the device's idle share of the step's wall time."""
    from lightgrad_tpu_torch.utils.profiler import Profiler

    with Profiler() as prof:
        step()
    n_fwd = sum(prof.fwd_count.values())
    n_bwd = sum(prof.bwd_count.values())
    traced, busy, _ = traced_families(step)
    fams = [f for _, f in KERNEL_FAMILIES] + ["plain torch"]
    ms = {f: traced.get(f, (0.0, 0))[0] for f in fams}
    n = {f: traced.get(f, (0.0, 0))[1] for f in fams}
    log(f"  tape ops a step: {n_fwd} forward, {n_bwd} backward; forward + "
        f"backward queued in {host_s * 1e3:.1f} ms of host time, "
        f"{host_s * 1e6 / (n_fwd + n_bwd):.1f} us an op")
    log(f"  device time of a step {busy:.1f} ms of {step_s * 1e3:.1f} ms "
        f"(idle {100 * (1 - busy / (step_s * 1e3)):.1f}%): "
        + ", ".join(f"{f} {t:.2f} ms ({n[f]})" for f, t in ms.items()))


def tape_steps(model, opt, x_ids, y, card, step1_check, **inputs):
    """BERT_STEPS training steps of a language model on the tape on one
    batch (``inputs``: BERT's ``attention_mask`` or ``attention_lengths``),
    then where a step's time goes.  ``step1_check(logits, loss)`` runs after
    step 1's backward, and its time is not the step's.  Returns the steps'
    launch counts."""
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    B, S = x_ids.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, host = [], [], []
    for step in range(BERT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(x_ids, **inputs)
        V = logits.shape[-1]
        loss = lg_loss.cross_entropy(logits.reshape(B * S, V), y,
                                     ignore_index=-100)
        opt.zero_grad()
        loss.backward()
        host.append(time.perf_counter() - t0)   # forward + backward queued
        if step == 0:               # the checks' time is not the step's
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            step1_check(logits, loss)
            # the peak of a training step, without the twin's gradients
            torch.cuda.reset_peak_memory_stats()
            t0 += time.perf_counter() - c0
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        del logits, loss
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    tok_s = B * S / float(np.median(times[1:]))
    log(f"  losses: {[round(v, 4) for v in losses]} "
        f"({'finite, falling' if ok else 'FAIL'})")
    log(f"  {B}x{S} tokens a step: {tok_s:.1f} tok/s (median of steps "
        f"2-{BERT_STEPS}, step times {[round(t, 4) for t in times]} s); "
        f"peak memory of steps 2-{BERT_STEPS} {peak / 2**30:.2f} GiB; {card}")
    log(f"  launches per step: "
        f"{ {k: v // BERT_STEPS for k, v in counts.items() if v} }")
    if not ok:
        raise AssertionError(f"loss not finite and falling: {losses}")
    step_breakdown(lambda: tape_step(model, opt, x_ids, y, **inputs),
                   float(np.median(times[1:])), float(np.median(host[1:])))
    return counts


def phase_bert(card):
    """Phase 6: BERT-base masked-LM training on the lightgrad tape (float32,
    AdamW, 5 steps on one batch) with the padding mask, checked against the
    plain twin, and one unmasked step; then a fresh BERT-base with the same
    weights through ``attention_lengths``, held to the same twin.  Returns
    the launch counts of the 5 masked steps, the unmasked step and the 5
    lengths steps."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim, random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    lg_random.seed(0)
    cfg = BertConfig(**BERT_BASE)
    model = BertForMaskedLM(cfg)
    ids, mask, labels, lengths = bert_batch(cfg)
    B, S, V = BERT_BATCH, BERT_SEQ, cfg.vocab_size
    log(f"  valid lengths {lengths.tolist()}, {int((labels >= 0).sum())} "
        f"labelled positions")
    dev, f32 = torch.device("cuda"), torch.float32
    tids = torch.tensor(ids, device=dev).long()
    tmask = torch.tensor(mask, device=dev)
    tlabels = torch.tensor(labels, device=dev).long()
    valid = tmask.bool()

    # the plain twin on the step-1 weights, in f32 and in f64: computed
    # once, it holds both branches
    def twin(dtype):
        params = {n: t.data.detach().to(dtype).requires_grad_(True)
                  for n, t in model.named_parameters()}
        logits = plain_bert(params, cfg, tids, tmask.to(dtype))
        loss = F.cross_entropy(logits.reshape(B * S, V), tlabels,
                               ignore_index=-100)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        return logits.detach(), loss.item(), grads

    plain_logits, plain_loss, grads32 = twin(torch.float32)
    _, _, grads64 = twin(torch.float64)
    torch.cuda.empty_cache()

    opt = optim.AdamW(list(model.parameters()), lr=BERT_LR)
    x_ids = Tensor.from_numpy(ids, requires_grad=False)
    x_mask = Tensor.from_numpy(mask, requires_grad=False)
    y = Tensor.from_numpy(labels, requires_grad=False)
    masked_rows = {}

    def check_masked(logits, loss):
        check("BERT-base masked-LM logits vs the plain twin", f32,
              logits.data, plain_logits, PATH_TOL[f32])
        log(f"  step-1 loss {loss.item():.5f}, plain twin {plain_loss:.5f}")
        tape_grad_check(model, grads32, grads64)
        masked_rows["logits"] = logits.data[valid]

    counts = tape_steps(model, opt, x_ids, y, card, check_masked,
                        attention_mask=x_mask)

    # one unmasked step: self-attention takes the flash kernels
    reset_launch_counts()
    loss = lg_loss.cross_entropy(model(x_ids).reshape(B * S, V), y,
                                 ignore_index=-100)
    opt.zero_grad()
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    flash = launch_counts()
    log(f"  unmasked step: loss {loss.item():.5f}, flash launches "
        f"{ {k: flash[k] for k in FLASH_KERNELS} }")
    if not np.isfinite(loss.item()):
        raise AssertionError("unmasked BERT step: loss not finite")
    del model, opt, loss
    torch.cuda.empty_cache()

    # attention_lengths: a fresh BERT-base, the same weights and batch.
    # The two branches differ only at padded query rows (zeros here), which
    # no valid row attends and no label reads: the same logits on valid
    # rows and the same gradients in exact arithmetic.
    log("  attention_lengths (the flash kernels with per-row lengths), a "
        "fresh BERT-base with the same weights:")
    lg_random.seed(0)
    model = BertForMaskedLM(cfg)
    opt = optim.AdamW(list(model.parameters()), lr=BERT_LR)
    x_lens = Tensor.from_numpy(lengths.astype(np.int32), requires_grad=False)

    def check_lengths(logits, loss):
        got = logits.data[valid]
        check("BERT-base attention_lengths logits (valid rows) vs the plain "
              "twin", f32, got, plain_logits[valid], PATH_TOL[f32])
        check("BERT-base attention_lengths logits (valid rows) vs the masked "
              "run's", f32, got, masked_rows["logits"], PATH_TOL[f32])
        log(f"  step-1 loss {loss.item():.5f}, plain twin {plain_loss:.5f}")
        tape_grad_check(model, grads32, grads64)

    lens_counts = tape_steps(model, opt, x_ids, y, card, check_lengths,
                             attention_lengths=x_lens)
    if lens_counts["softmax_fwd"] or lens_counts["softmax_bwd"]:
        raise AssertionError("attention_lengths launched the softmax "
                             "kernels")
    del model, opt, grads32, grads64, plain_logits, masked_rows
    torch.cuda.empty_cache()
    return counts, flash, lens_counts


def phase_quant_bert():
    """The tape's int8 ``QuantLinear``: a fresh BERT-base (the BERT phase's
    config and 8 x 128 batch) after ``quantize_module(min_features=64)``,
    one forward against the float model's logits (cosine, as
    tests/test_quant.py bounds a module) and one finite backward."""
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import no_grad, random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.quant import quantize_module

    lg_random.seed(0)
    cfg = BertConfig(**BERT_BASE)
    model = BertForMaskedLM(cfg)
    ids, mask, labels, _ = bert_batch(cfg)
    x_ids = Tensor.from_numpy(ids, requires_grad=False)
    x_mask = Tensor.from_numpy(mask, requires_grad=False)
    y = Tensor.from_numpy(labels, requires_grad=False)
    with no_grad():
        want = model(x_ids, attention_mask=x_mask).data.float()
    quantize_module(model, min_features=64)
    n_quant = sum(1 for n, _ in model.named_buffers()
                  if n.endswith("weight_q"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = model(x_ids, attention_mask=x_mask)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    got = logits.data.float()
    cos = float((got * want).sum() / (got.norm() * want.norm()))
    loss = lg_loss.cross_entropy(logits.reshape(-1, cfg.vocab_size), y,
                                 ignore_index=-100)
    loss.backward()
    grads = [t.grad for t in model.parameters() if t.grad is not None]
    finite = all(bool(torch.isfinite(g.data).all()) for g in grads)
    ok = cos >= 0.99 and finite and np.isfinite(loss.item())
    log(f"  {n_quant} Linear layers int8; forward {fwd_s * 1e3:.1f} ms; "
        f"logits cosine vs the float model {cos:.6f} (>= 0.99); loss "
        f"{loss.item():.5f}; {len(grads)} parameter gradients, "
        f"{'finite' if finite else 'NOT finite'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"quantized BERT: cosine {cos}, finite "
                             f"{finite}")
    del model, logits, loss, grads
    torch.cuda.empty_cache()


class _PlainConv(torch.autograd.Function):
    """Convolution for the plain twin: the kernels' plain versions in both
    directions."""

    @staticmethod
    def forward(ctx, x, w, stride):
        from lightgrad_tpu_torch.ops.conv import conv_fwd_reference

        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return conv_fwd_reference(x, w, stride)

    @staticmethod
    def backward(ctx, g):
        from lightgrad_tpu_torch.ops.conv import (conv_bwd_dw_reference,
                                                  conv_bwd_dx_reference)

        x, w = ctx.saved_tensors
        gx = conv_bwd_dx_reference(g, w, x.shape, ctx.stride) \
            if ctx.needs_input_grad[0] else None
        return gx, conv_bwd_dw_reference(g, x, w.shape, ctx.stride), None


class _MaskedRelu(torch.autograd.Function):
    """ReLU that keeps the elements of a given mask (the tape's own
    decisions), in both directions."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return torch.where(mask, x, torch.zeros_like(x))

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros_like(g)), None


class _MaskedMax(torch.autograd.Function):
    """Max over axis 0 whose gradient goes to the given winners (the tape's
    own), every one of them, as the tape's max does."""

    @staticmethod
    def forward(ctx, x, winners):
        ctx.save_for_backward(winners)
        return x.amax(0)

    @staticmethod
    def backward(ctx, g):
        (winners,) = ctx.saved_tensors
        return torch.where(winners, g.unsqueeze(0), torch.zeros_like(g)), \
            None


class TapeDecisions:
    """Records, during forward passes of the tape, each ReLU's mask (input
    > 0) and each max over axis 0's winners (input == max), in call order.
    ReLU and max pooling have discontinuous derivatives: a pre-activation
    within rounding of 0 (``h + skip`` cancelling to ~1e-8) or two window
    values within rounding of each other decide differently in any two
    evaluations, and each such flip moves whole weight gradients.  A twin
    that takes the tape's decisions checks the arithmetic alone."""

    def __enter__(self):
        from lightgrad_tpu_torch.autograd.cuda import ops

        self.relu, self.max = [], []
        self._ops, self._ew, self._reduce = ops, ops.ew, ops.kreduce

        def ew(body, *xs, **kwargs):
            if body == "f_relu":
                self.relu.append(xs[0] > 0)
            return self._ew(body, *xs, **kwargs)

        def kreduce(x, op, axis=None, keepdims=False):
            y = self._reduce(x, op, axis=axis, keepdims=keepdims)
            if op == "max" and axis == 0:
                self.max.append(x == (y if keepdims else y.unsqueeze(0)))
            return y

        ops.ew, ops.kreduce = ew, kreduce
        return self

    def __exit__(self, *exc):
        self._ops.ew, self._ops.kreduce = self._ew, self._reduce


def plain_resnet(p, model, x, decisions=None):
    """A ResNet's logits through the plain PyTorch versions of the kernels
    (``_reference``) in the tape's formulas -- BatchNorm on the batch's
    statistics, max pooling as a max over shifted slices of a -1e30 pad --
    differentiable by torch autograd: the twin the tape's step must meet.
    ``p``: the model's parameters by name; ``model`` gives the layout;
    ``decisions``: a :class:`TapeDecisions` whose ReLU masks and max
    winners the twin takes instead of its own."""
    import torch.nn.functional as F

    masks = iter(decisions.relu) if decisions else None
    winners = iter(decisions.max) if decisions else None

    def relu(t):
        return _MaskedRelu.apply(t, next(masks)) if masks else t.relu()

    def conv(y, name, layer):
        if layer.p:
            y = F.pad(y, (layer.p,) * 4)
        return _PlainConv.apply(y, p[name + ".w"], layer.s)

    def bn(y, name):
        c = (1, y.shape[1], 1, 1)
        d = y - y.mean((0, 2, 3)).reshape(c)
        v = (d * d).mean((0, 2, 3)).reshape(c)
        return d / (v + 1e-5) ** 0.5 * p[name + ".weight"].reshape(c) \
            + p[name + ".bias"].reshape(c)

    y = relu(bn(conv(x, "stem", model.stem), "bstem"))
    if model.stem_pool:
        y = F.pad(y, (1, 1, 1, 1), value=-1e30)
        oh, ow = (y.shape[2] - 3) // 2 + 1, (y.shape[3] - 3) // 2 + 1
        y = torch.stack([y[:, :, i:i + 2 * oh - 1:2, j:j + 2 * ow - 1:2]
                         for i in range(3) for j in range(3)])
        y = _MaskedMax.apply(y, next(winners)) if winners else y.amax(0)
    for i, blk in enumerate(model.blocks):
        pre = f"blocks.{i}."
        h = relu(bn(conv(y, pre + "c1", blk.c1), pre + "b1"))
        h = bn(conv(h, pre + "c2", blk.c2), pre + "b2")
        skip = y if blk.proj is None else \
            bn(conv(y, pre + "proj", blk.proj), pre + "bproj")
        y = relu(h + skip)
    # the head in plain torch, which keeps the f64 twin in f64 (the matmul
    # kernel's plain version sums in f32)
    return y.mean((2, 3)) @ p["fc.weight"].T + p["fc.bias"]


def resnet_step(model, opt, x, y):
    """One classification training step of a ResNet on the tape."""
    from lightgrad_tpu_torch import loss as lg_loss

    loss = lg_loss.cross_entropy(model(x), y)
    opt.zero_grad()
    loss.backward()
    opt.step()


def phase_resnet18(card):
    """Phase 8a: ResNet-18 at its torchvision widths on the lightgrad tape,
    float32, AdamW, 5 steps on one batch of random images; step 1 checked
    against the plain twin in f32 and f64, which take the tape's ReLU and
    max-pool decisions (:class:`TapeDecisions`).  Returns the 5 steps'
    launch counts."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import no_grad, optim, random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models import resnet18
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    lg_random.seed(0)
    model = resnet18()
    n_params = sum(int(np.prod(t.shape)) for t in model.parameters())
    B, dev = RESNET_BATCH, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    S = RESNET_IMAGE
    xd = torch.randn(B, 3, S, S, generator=gen, device=dev)
    yd = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    log(f"  {n_params / 1e6:.2f} M parameters, {B} x 3 x {S} x {S} images")

    # the plain twin on the step-1 weights, in f32 and in f64
    def twin(dtype, decisions=None):
        params = {n: t.data.detach().to(dtype).requires_grad_(True)
                  for n, t in model.named_parameters()}
        logits = plain_resnet(params, model, xd.to(dtype), decisions)
        loss = F.cross_entropy(logits, yd)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        return logits.detach(), loss.item(), grads

    opt = optim.AdamW(list(model.parameters()), lr=RESNET_LR)
    x = Tensor(xd, requires_grad=False)
    y = Tensor(yd.to(torch.int32), requires_grad=False)
    stats0 = {n: b.data.clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, host = [], [], []
    for step in range(RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step == 0:
            with TapeDecisions() as decisions:
                logits = model(x)
        else:
            logits = model(x)
        loss = lg_loss.cross_entropy(logits, y)
        opt.zero_grad()
        loss.backward()
        host.append(time.perf_counter() - t0)   # forward + backward queued
        if step == 0:               # the checks' time is not the step's
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            own = twin(torch.float32)[2]
            plain_logits, plain_loss, grads32 = twin(torch.float32,
                                                     decisions)
            grads64 = twin(torch.float64, decisions)[2]
            check("ResNet-18 logits vs the plain twin", torch.float32,
                  logits.data, plain_logits, PATH_TOL[torch.float32])
            log(f"  step-1 loss {loss.item():.5f}, plain twin "
                f"{plain_loss:.5f}")
            flips = max(
                (t.grad.data - own[n]).abs().max().item()
                / max(own[n].abs().max().item(), 1e-30)
                for n, t in model.named_parameters())
            log(f"  the twins take the tape's {len(decisions.relu)} ReLU "
                f"masks and {len(decisions.max)} max-pool winners; with its "
                f"own, the f32 twin's gradients are {flips:.3e} off "
                f"(decisions that flip under rounding)")
            tape_grad_check(model, grads32, grads64)
            del grads32, grads64, plain_logits, own, decisions
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 += time.perf_counter() - c0
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        del logits, loss
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    img_s = B / float(np.median(times[1:]))
    log(f"  losses: {[round(v, 4) for v in losses]} "
        f"({'finite, falling' if ok else 'FAIL'})")
    log(f"  {B} images a step: {img_s:.1f} images/s (median of steps "
        f"2-{RESNET_STEPS}, step times {[round(t, 4) for t in times]} s); "
        f"peak memory of steps 2-{RESNET_STEPS} {peak / 2**30:.2f} GiB; "
        f"{card}")
    log(f"  launches per step: "
        f"{ {k: v // RESNET_STEPS for k, v in counts.items() if v} }")
    if not ok:
        raise AssertionError(f"ResNet-18 loss not finite and falling: "
                             f"{losses}")
    still = [n for n, b in model.named_buffers()
             if torch.equal(b.data, stats0[n])]
    model.eval()
    with no_grad():
        ev = model(x).data
    model.train()
    finite = bool(torch.isfinite(ev).all())
    log(f"  BatchNorm running statistics: {len(stats0) - len(still)} of "
        f"{len(stats0)} moved; eval forward {tuple(ev.shape)} "
        f"{'finite' if finite else 'NOT finite'}")
    if still or not finite:
        raise AssertionError(f"running statistics that did not move: "
                             f"{still}; eval forward finite: {finite}")
    step_breakdown(lambda: resnet_step(model, opt, x, y),
                   float(np.median(times[1:])), float(np.median(host[1:])))
    del model, opt, x, y, ev
    torch.cuda.empty_cache()
    return counts


def phase_narrow():
    """Phase 8b: ``narrow`` at a 0-d device start (past n - length, so it
    clamps), forward and backward, under sync debug mode: the start never
    reaches the host."""
    from lightgrad_tpu_torch.autograd import Tensor

    dev = torch.device("cuda")
    x = Tensor(torch.randn(60_000, 784, device=dev))
    at = 60_000 - MNIST_BATCH // 2               # past n - length: clamps
    start = Tensor(torch.tensor(at, device=dev, dtype=torch.int32),
                   requires_grad=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = x.narrow(start, MNIST_BATCH)
        y.backward(allow_fill=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = 60_000 - MNIST_BATCH
    ok = torch.equal(y.data, x.data[n:]) and bool(
        (x.grad.data[n:] == 1).all()) and not bool(x.grad.data[:n].any())
    log(f"  narrow({tuple(x.shape)}, start {at} -> {n}, {MNIST_BATCH}) "
        f"forward + backward under sync debug mode \"error\": no "
        f"synchronisation; rows and gradient {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("narrow at a device start: wrong rows or "
                             "gradient")


def _kv_groups(q, *kv_like, extra=()):
    """Per KV head j: q's heads j*rep..(j+1)*rep-1 (and those of each
    q-shaped tensor in ``extra``), and K/V head j, as (b, heads, S, hd)
    views: a grouped-query attention split into independent groups."""
    kvh = kv_like[0].shape[1]
    rep = q.shape[1] // kvh
    for j in range(kvh):
        qs = [t[:, j * rep:(j + 1) * rep] for t in (q, *extra)]
        yield qs, [t[:, j:j + 1] for t in kv_like]


class _PlainAttention(torch.autograd.Function):
    """Grouped-query attention for the plain twins, causal (banded) or not:
    the flash kernels' plain versions (``attention_fwd_reference``,
    ``attention_bwd_reference``), one KV group at a time, so the f32 scores
    of a long sequence exist for one group at once; the backward recomputes
    them.  q (b, H, S, hd), k and v (b, KV, S, hd)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, causal):
        from lightgrad_tpu_torch.ops.attention import attention_fwd_reference

        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.window, ctx.causal = scale, window, causal
        return torch.cat([attention_fwd_reference(qg, kg, vg, scale, causal,
                                                  window=window)[0]
                          for (qg,), (kg, vg) in _kv_groups(q, k, v)], 1)

    @staticmethod
    def backward(ctx, g):
        from lightgrad_tpu_torch.ops.attention import attention_bwd_reference

        q, k, v = ctx.saved_tensors
        parts = [attention_bwd_reference(gg, qg, kg, vg, ctx.scale,
                                         ctx.causal, window=ctx.window)
                 for (qg, gg), (kg, vg) in _kv_groups(q, k, v,
                                                      extra=(g,))]
        dq, dk, dv = (torch.cat(t, 1) for t in zip(*parts))
        return dq, dk, dv, None, None, None


def plain_moe(h2, p, pre, cfg, lin_w, act, routes=None, aux=None,
              ids=None):
    """Mixtral's routed FFN of rows ``h2 (..., d)``, plain: the router's
    softmax in f32, ``torch.topk`` of it (its own rule; the model breaks an
    exact tie to the lowest index) or the given experts ``ids (rows, k)``,
    renormalised gates, every expert over every row weighted by its gate.
    ``routes`` collects (probs, its own top-k ids) a layer; ``aux``
    collects the Switch load-balancing loss on the first choice."""
    E, k = cfg.num_local_experts, cfg.num_experts_per_tok
    d = h2.shape[-1]
    x = h2.reshape(-1, d)
    pre = pre + "block_sparse_moe."
    probs = torch.softmax(lin_w(x, p[pre + "router.weight"].T).float(), -1)
    own = probs.topk(k, -1)[1]
    ids = own if ids is None else ids
    top = probs.gather(-1, ids)
    gates = (top / (top.sum(-1, keepdim=True) + 1e-9)).to(h2.dtype)
    comb = torch.zeros_like(probs, dtype=h2.dtype).scatter(-1, ids, gates)
    if routes is not None:
        routes.append((probs.detach(), own))
    if aux is not None:
        frac = torch.zeros_like(probs).scatter(-1, ids[:, :1], 1.0)
        aux.append((frac.mean(0) * probs.mean(0)).sum() * E)
    out = 0
    for e in range(E):
        w1, w3, w2 = (p[pre + w][e] for w in ("w1", "w3", "w2"))
        y = lin_w(act(lin_w(x, w1)) * lin_w(x, w3), w2)
        out = out + y * comb[:, e:e + 1]
    return out.reshape(h2.shape)


def int8_roundtrip(x):
    """``x (..., hd)`` in f32 after ``quantize_kv``'s rule and back: a
    scale a row ``max(|x|, 1e-8) / 127``, rounded half to even, clipped to
    +-127, times the scale."""
    x = x.float()
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127) * s


def plain_llama(p, cfg, ids, routes=None, aux=None, kv_from=None,
                route_ids=None):
    """Logits (b, T, vocab) of ``Llama.forward`` through the plain PyTorch
    versions of the kernels (``_reference``), differentiable by torch
    autograd, attention one KV group at a time: the twin of the tape's step
    and the full-sequence reference of the KV path.  Computes in ``p``'s
    dtype, every product summed in f32 and rounded once.  Its RoPE tables
    are its own: pair i of position t turns by t * theta^(-2i / hd), in numpy
    f32 arithmetic as the model's (torch's f32 power differs by an ulp at
    some i, which moves position 8191's angles by up to 1e-3).  Mixtral's
    blocks through :func:`plain_moe` (``routes``, ``aux``: its records;
    ``route_ids``: the experts each layer takes, (b T, k) a layer);
    ``p["head.weight"]``, where given, is the LM head (an int8 head
    dequantized).  ``kv_from``: the query rows from this position on
    attend the K/V rows through :func:`int8_roundtrip`, in f32, as the
    steps over an int8 cache do (0 for Mixtral, whose prefill over an int8
    cache attends the rows it quantized)."""
    from lightgrad_tpu_torch.ops.elementwise import ew_reference
    from lightgrad_tpu_torch.ops.matmul import matmul_reference

    b, T = ids.shape
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    eps, off = cfg.rms_norm_eps, 1.0 if cfg.rms_offset else 0.0
    emb = p["embed_tokens.weight"]
    win = cfg.sliding_window or 0
    win = win if win < T else 0         # the model's rule
    pair = np.arange(hd // 2, dtype=np.float32)
    turn = np.float32(1.0) / np.float32(cfg.rope_theta) ** (
        2 * pair / np.float32(hd))
    ang = np.arange(T, dtype=np.float32)[:, None] * turn
    ang = np.concatenate([ang, ang], -1)      # x1 and x2 share pair i's angle
    cos, sin = (torch.from_numpy(f(ang)).to(device=emb.device,
                                            dtype=emb.dtype)
                for f in (np.cos, np.sin))

    def lin(x, name):
        y = matmul_reference(x, p[name + ".weight"].T)
        bias = p.get(name + ".bias")
        return y if bias is None else y + bias

    def silu(g):
        return torch.sigmoid(g) * g

    def rms(x, name):
        w = p[name + ".weight"]
        var = (x * x).mean(-1, keepdim=True)
        return x * (var + eps) ** -0.5 * (w + off if off else w)

    def rope(x):
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return x * cos + torch.cat([-x2, x1], -1) * sin

    def heads(x, n):
        return x.reshape(b, T, n, hd).transpose(1, 2)

    x = emb[ids]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    for l in range(cfg.num_hidden_layers):
        pre = f"layers.{l}."
        h = rms(x, pre + "input_layernorm")
        q = rope(heads(lin(h, pre + "self_attn.q_proj"), H))
        k = rope(heads(lin(h, pre + "self_attn.k_proj"), KV))
        v = heads(lin(h, pre + "self_attn.v_proj"), KV)
        if kv_from != 0:
            att = _PlainAttention.apply(q, k, v, hd ** -0.5, win, True)
        if kv_from is not None:
            attq = _PlainAttention.apply(q.float(), int8_roundtrip(k),
                                         int8_roundtrip(v), hd ** -0.5,
                                         win, True).to(q.dtype)
            att = attq if kv_from == 0 else torch.cat(
                [att[:, :, :kv_from], attq[:, :, kv_from:]], 2)
        x = x + lin(att.transpose(1, 2).reshape(b, T, H * hd),
                    pre + "self_attn.o_proj")
        h2 = rms(x, pre + "post_attention_layernorm")
        if cfg.num_local_experts:
            x = x + plain_moe(h2, p, pre, cfg, matmul_reference, silu,
                              routes, aux, route_ids and route_ids[l])
            continue
        g = lin(h2, pre + "mlp.gate_proj")
        a = ew_reference("f_gelu", g) if cfg.hidden_act != "silu" \
            else silu(g)
        x = x + lin(a * lin(h2, pre + "mlp.up_proj"), pre + "mlp.down_proj")
    x = rms(x, "norm")
    head = p.get("head.weight")
    if head is None:
        head = emb if cfg.tie_word_embeddings else p["lm_head.weight"]
    return matmul_reference(x, head.T)


def band_pairs(S, window):
    """Valid (query, key) pairs of one head under the causal mask, banded
    by ``window`` (0: none): the work that this call's band needs."""
    i = np.arange(S)
    return float(np.minimum(i + 1, window if window else S).sum())


def sdpa(q, k, v, band):
    """One PyTorch call of the same attention: q (H, S, hd), k and v (KV, S,
    hd) grouped; causal, or under the boolean ``band`` mask."""
    import torch.nn.functional as F

    if band is None:
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=True, enable_gqa=True)
    return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                          attn_mask=band, enable_gqa=True)


def library_time(what, dtype, timing):
    """``timing()`` (a library call's milliseconds), or None (logged) where
    PyTorch refuses the call."""
    try:
        return timing()
    except RuntimeError as e:
        log(f"  {what} {str(dtype)[6:]}: no library time, PyTorch refused "
            f"the call: {str(e).splitlines()[0][:160]}")
        return None


def phase_llama_kernels(results):
    """Phase 3, the LLaMA family's attention kernels: the band (7W, 8W) at
    a Mistral-7B layer, q (32, 8192, 128) and k/v (8, 8192, 128), window
    4096; head dim 256 (7D, 8D) at Gemma-2B's prefill, q (8, 8192, 256) and
    k/v (1, 8192, 256), and its training shape, 2 x 8 heads of 1024; head
    dim 32 at the char example's 16 x 4 heads of 64, G 2; correctness only
    at head dims 8, 16 and 80 and at windows of S or more; and decode
    attention (11D) at Gemma's (1, 8, 256) over W 8192 at pos 4096 and
    Mistral's (8, 4, 128) at pos 6000, window 4096.  The plain versions run
    one KV group at a time (a full (32, 8192, 8192) f32 score tensor is 8.6
    GB); the bounds count the band's pairs only."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_dkv, attention_bwd_dq, attention_fwd_res,
        attention_fwd_reference)
    from lightgrad_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_batch,
        decode_attention_batch_reference, decode_attention_reference,
        decode_merge, decode_merge_reference, plan_splits, split_bounds,
        split_partials, visible_range)

    dev, f32 = torch.device("cuda"), torch.float32
    g = torch.Generator(device=dev).manual_seed(13)
    M, Gm = MISTRAL_7B, GEMMA_2B
    mistral = (M["num_attention_heads"], M["num_key_value_heads"],
               M["max_position_embeddings"],
               M["hidden_size"] // M["num_attention_heads"],
               M["sliding_window"])
    # (variant, H, KV, S, hd, window, with the backward)
    timed_cases = (("window_", *mistral, True),
                   ("d256_", Gm["num_attention_heads"],
                    Gm["num_key_value_heads"], Gm["max_position_embeddings"],
                    Gm["head_dim"], 0, False),
                   ("d256_train_", 2 * Gm["num_attention_heads"],
                    2 * Gm["num_key_value_heads"], 1024, Gm["head_dim"], 0,
                    True),
                   ("d32_", 16 * 4, 16 * 2, 64, 32, 0, True))
    # (H, KV, S, hd, window): correctness only
    odd_cases = ((8, 4, 256, 8, 100), (8, 4, 256, 16, 256),
                 (8, 2, 200, 80, 500), (8, 4, 300, 80, 64),
                 (4, 4, 129, 200, 0))
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]
        isz = torch.tensor([], dtype=dtype).element_size()

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        for variant, H, KV, S, hd, window, bwd in timed_cases:
            tag = f"({H}, {S}, {hd}) KV={KV} window={window}"
            q, k, v, do = rnd(H, S, hd), rnd(KV, S, hd), rnd(KV, S, hd), \
                rnd(H, S, hd)
            sc = hd ** -0.5
            out, lse = attention_fwd_res(q, k, v, sc, True, window=window)
            got = attention_bwd(do, q, k, v, sc, True, out=out, lse=lse,
                                window=window) if bwd else None
            band = None
            if window and window < S:
                i = torch.arange(S, device=dev)
                band = (i[None, :] <= i[:, None]) \
                    & (i[:, None] - i[None, :] < window)
            # the first and the last KV group against the plain versions
            rep = H // KV
            err, errs = 0.0, [0.0, 0.0, 0.0]
            for j in sorted({0, KV - 1}):
                qs, ks = slice(j * rep, (j + 1) * rep), slice(j, j + 1)
                ro, rl = attention_fwd_reference(q[qs], k[ks], v[ks], sc,
                                                 True, window=window)
                # plausible faults: zeros; in the first group no causal
                # mask, the band dropped, and (check_fwd) the last K tile
                wrong = [torch.zeros_like(ro)]
                if j == 0:
                    wrong.append(attention_fwd_reference(
                        q[qs], k[ks], v[ks], sc, False)[0])
                    if window:
                        wrong.append(attention_fwd_reference(
                            q[qs], k[ks], v[ks], sc, True)[0])
                lib = None
                if j == 0 and dtype == torch.bfloat16:
                    lib = library_time(f"attention_fwd {variant}", dtype,
                                       lambda: sdpa(q[qs], k[ks], v[ks],
                                                    band)[0])
                err = max(err, check_fwd(
                    f"attention_fwd {tag} group {j} out", dtype, out[qs], ro,
                    *wrong, q=q[qs], k=k[ks], v=v[ks], scale=sc,
                    drop=32 if hd > 128 else 64, library=lib))
                del lib
                check(f"attention_fwd {tag} group {j} lse", dtype, lse[qs],
                      rl, KERNEL_TOL[f32])
                del ro, rl, wrong
                if bwd:
                    want, allow = bwd_reference(
                        dtype, do[qs], q[qs], k[ks], v[ks], out[qs], lse[qs],
                        sc, True, window=window)
                    parts = (got[0][qs], got[1][ks], got[2][ks])
                    for i, (n, a, w, al) in enumerate(zip(
                            ("dq", "dk", "dv"), parts, want, allow)):
                        errs[i] = max(errs[i], check_bwd(
                            f"attention_bwd {tag} group {j} {n}", dtype, a, w,
                            tol, allow=al))
                    del allow
                    for w in want:
                        discriminates("attention_bwd", dtype, w, tol,
                                      torch.zeros_like(w))
                    del want
                torch.cuda.empty_cache()
            npairs = H * band_pairs(S, window)

            def plain_fwd():
                for (qg,), (kg, vg) in _kv_groups(q[None], k[None], v[None]):
                    attention_fwd_reference(qg, kg, vg, sc, True,
                                            window=window)

            tile, kvt = H * S * hd * isz, KV * S * hd * isz
            cost, peak = flash_cost(dtype, 2 * tile + 2 * kvt + H * S * 4,
                                    4 * hd * npairs)
            record(results, dtype, "attention_fwd", err,
                   cuda_ms(lambda: attention_fwd_res(q, k, v, sc, True,
                                                     window=window)),
                   cuda_ms(plain_fwd, 2),
                   cost=cost, peak=peak, library_ms=library_time(
                       f"attention_fwd {variant}", dtype,
                       lambda: cuda_ms(lambda: sdpa(q, k, v, band), 5)),
                   variant=variant)
            if bwd:
                dcap = (do.float() * out.float()).sum(-1).contiguous()

                def plain_bwd():
                    for (qg, gg, og, lg), (kg, vg) in _kv_groups(
                            q[None], k[None], v[None],
                            extra=(do[None], out[None], lse[None])):
                        bwd_plain(dtype, gg, qg, kg, vg, og, lg, sc, True,
                                  window=window)

                def library_bwd():
                    # the library's backward: dq, dk and dv in one call, its
                    # time (by CUDA graph; eager logged) beside both passes
                    ts = [t.detach().requires_grad_() for t in (q, k, v)]
                    o = sdpa(*ts, band)
                    eager = cuda_ms(lambda: torch.autograd.grad(
                        o, ts, do[None], retain_graph=True), 5)
                    log(f"  attention_bwd SDPA {variant}{str(dtype)[6:]}: "
                        f"{eager:.4f} ms eager")
                    del o, ts
                    kw = ({"is_causal": True} if band is None
                          else {"attn_mask": band})
                    return sdpa_bwd_ms(q[None], k[None], v[None], do[None],
                                       enable_gqa=True, **kw)

                plain_ms = cuda_ms(plain_bwd, 2)
                lib_ms = library_time(f"attention_bwd {variant}", dtype,
                                      library_bwd)
                dq_fn = lambda: attention_bwd_dq(do, q, k, v, lse, dcap, sc,
                                                 True, window=window)
                dkv_fn = lambda: attention_bwd_dkv(do, q, k, v, lse, dcap,
                                                   sc, True, window=window)
                cost, peak = flash_cost(dtype, 3 * tile + 2 * kvt
                                       + 2 * H * S * 4, 6 * hd * npairs)
                record(results, dtype, "attention_bwd_dq", errs[0],
                       cuda_ms(dq_fn), plain_ms, cost=cost,
                       library_ms=lib_ms, variant=variant,
                       graph=graph_ms(dq_fn, 5), peak=peak)
                cost, peak = flash_cost(dtype, 2 * tile + 4 * kvt
                                       + 2 * H * S * 4, 8 * hd * npairs)
                record(results, dtype, "attention_bwd_dkv", max(errs[1:]),
                       cuda_ms(dkv_fn), plain_ms, cost=cost,
                       library_ms=lib_ms, variant=variant,
                       graph=graph_ms(dkv_fn, 5), peak=peak)
                del dcap
            del q, k, v, do, out, lse, got, band
            torch.cuda.empty_cache()

        for H, KV, S, hd, window in odd_cases:
            tag = f"({H}, {S}, {hd}) KV={KV} window={window}"
            q, do = rnd(H, S, hd), rnd(H, S, hd)
            k, v = rnd(KV, S, hd), rnd(KV, S, hd)
            sc = hd ** -0.5
            out, lse = attention_fwd_res(q, k, v, sc, True, window=window)
            got = attention_bwd(do, q, k, v, sc, True, out=out, lse=lse,
                                window=window)
            ro, rl = attention_fwd_reference(q, k, v, sc, True,
                                             window=window)
            want, allow = bwd_reference(dtype, do, q, k, v, out, lse, sc,
                                        True, window=window)
            record(results, dtype, "attention_fwd",
                   check_fwd(f"attention_fwd {tag} out", dtype, out, ro,
                             torch.zeros_like(ro)))
            check(f"attention_fwd {tag} lse", dtype, lse, rl, KERNEL_TOL[f32])
            errs = [check_bwd(f"attention_bwd {tag} {n}", dtype, a, w, tol,
                              allow=al)
                    for n, a, w, al in zip(("dq", "dk", "dv"), got, want,
                                           allow)]
            record(results, dtype, "attention_bwd_dq", errs[0])
            record(results, dtype, "attention_bwd_dkv", max(errs[1:]))

        # decode attention: (variant, KV, G, hd, W, pos, window)
        for variant, KV, G, hd, W, pos, window in (
                ("gemma_", Gm["num_key_value_heads"],
                 Gm["num_attention_heads"] // Gm["num_key_value_heads"],
                 Gm["head_dim"], Gm["max_position_embeddings"], 4096, 0),
                ("mistral_", M["num_key_value_heads"],
                 M["num_attention_heads"] // M["num_key_value_heads"],
                 mistral[3], M["max_position_embeddings"], 6000,
                 M["sliding_window"])):
            q1 = rnd(KV, G, hd)
            kc, vc = rnd(KV, W, hd), rnd(KV, W, hd)
            sc = hd ** -0.5
            got = decode_attention(q1, kc, vc, pos, sc, window)
            want = decode_attention_reference(q1, kc, vc, pos, sc, window)
            lo, hi = visible_range(W, pos, window)
            nv = hi + 1 - lo
            # planned from the most rows the cache shows, not from pos
            n_split = plan_splits(KV, W, window, hd, dtype)
            bounds = split_bounds(lo, nv, n_split)
            # plausible faults: zeros, the first or the last 2048 keys
            # alone, the first or the last split's range alone (a broken
            # merge), no band
            wrong = [torch.zeros_like(want)]
            if nv > 2048:
                wrong += [decode_attention_reference(q1, kc, vc, lo + 2047,
                                                     sc, 2048),
                          decode_attention_reference(q1, kc, vc, pos, sc,
                                                     2048)]
            for s0, s1 in ((bounds[0], bounds[1]), (bounds[-2], bounds[-1])):
                wrong.append(decode_attention_reference(q1, kc, vc, s1 - 1,
                                                        sc, s1 - s0))
            if window:
                wrong.append(decode_attention_reference(q1, kc, vc, pos, sc))
            # one ulp of each element allowed beside the rms share: the bf16
            # kernel rounds P to bf16 (as the TPU kernel does), and a
            # rounding of the output may land on the neighbouring value
            err = check_ulp(f"decode_attention {variant[:-1]} ({KV}, {G}, "
                            f"{hd}) pos={pos} window={window} n_split="
                            f"{n_split}", dtype, got, want, tol, *wrong)
            del wrong
            kv_vis = (kc[:, lo:pos + 1][None], vc[:, lo:pos + 1][None])
            qh = q1.reshape(1, KV * G, 1, hd)
            # device time by CUDA graph, the library's too
            record(results, dtype, "decode_attention", err,
                   graph_ms(lambda: decode_attention(q1, kc, vc, pos, sc,
                                                     window)),
                   graph_ms(lambda: decode_attention_reference(
                       q1, kc, vc, pos, sc, window)), timing="graph",
                   cost=((2 * KV * nv * hd + 2 * KV * G * hd) * isz,
                         4 * KV * G * nv * hd),
                   library_ms=library_time(
                       f"decode_attention {variant}", dtype,
                       lambda: graph_ms(lambda: F.scaled_dot_product_attention(
                           qh, *kv_vis, enable_gqa=True))),
                   variant=variant)
            key = ("bf16_" if dtype == torch.bfloat16 else "") + variant
            results["decode_attention"][key + "n_split"] = n_split
            # the merge kernel alone, on the plain split's partials at this
            # call's splits: its bytes are the partials and the output
            part = split_partials(q1, kc, vc, pos, sc, window, n_split)
            mout = decode_merge(part, torch.empty_like(q1), n_split)
            mref = decode_merge_reference(part, KV, G, hd, n_split, dtype)
            merr = check_ulp(f"decode_attention_merge {variant[:-1]} "
                             f"n_split={n_split}", dtype, mout, mref, tol,
                             torch.zeros_like(mref))
            record(results, dtype, "decode_attention_merge", merr,
                   graph_ms(lambda: decode_merge(part, mout, n_split)),
                   graph_ms(lambda: decode_merge_reference(
                       part, KV, G, hd, n_split, dtype)), timing="graph",
                   cost=(part.numel() * 4 + KV * G * hd * isz,
                         3 * part.numel()),
                   library_ms=None,
                   variant="" if variant == "gemma_" else variant)
            del part, mout, mref
            del q1, kc, vc, kv_vis

        # the batched decode attention (LLaMA's step_batch: the JAX
        # package's jax.vmap of the kernel) at the engines' 4 slots, each at
        # its own device position, over the strided slot views of a stacked
        # (B, L, 2, KV, W, hd) cache cut to one layer
        for variant, KV, G, hd, W, window, poss in (
                ("gemma_", Gm["num_key_value_heads"],
                 Gm["num_attention_heads"] // Gm["num_key_value_heads"],
                 Gm["head_dim"], Gm["max_position_embeddings"], 0,
                 (1200, 16, 500, 800)),
                ("mistral_", M["num_key_value_heads"],
                 M["num_attention_heads"] // M["num_key_value_heads"],
                 mistral[3], M["max_position_embeddings"],
                 M["sliding_window"], (4600, 32, 700, 2100))):
            B, sc = len(poss), hd ** -0.5
            caches = rnd(B, 1, 2, KV, W, hd)
            kc, vc = caches[:, 0, 0], caches[:, 0, 1]
            qb = rnd(B, KV, G, hd)
            pt = torch.tensor(poss, device=dev, dtype=torch.int32)
            got = decode_attention_batch(qb, kc, vc, pt, sc, window)
            want = decode_attention_batch_reference(qb, kc, vc, pt, sc,
                                                    window)
            singles = torch.stack([decode_attention_reference(
                qb[b], kc[b], vc[b], p, sc, window)
                for b, p in enumerate(poss)])
            err = check_ulp(f"decode_attention_batch {variant[:-1]} B={B} "
                            f"poss={list(poss)}", dtype, got, want, tol,
                            torch.zeros_like(want), singles.roll(1, 0))
            check("decode_attention_batch vs one reference a slot", dtype,
                  want, singles, tol)
            # one capture, replayed after the positions move
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                decode_attention_batch(qb, kc, vc, pt, sc, window)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = decode_attention_batch(qb, kc, vc, pt, sc, window)
            moved = [p + 37 for p in poss]
            pt.copy_(torch.tensor(moved, device=dev))
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(replayed, decode_attention_batch(
                    qb, kc, vc, pt, sc, window)):
                raise AssertionError("decode_attention_batch: a replay at "
                                     "moved positions differs from an eager "
                                     "call")
            del graph
            pt.copy_(torch.tensor(poss, device=dev))
            nvis = [visible_range(W, p, window) for p in poss]
            nbytes = sum(2 * KV * (hi - lo + 1) * hd for lo, hi in nvis) \
                * isz + 2 * B * KV * G * hd * isz
            ops = sum(4 * KV * G * (hi - lo + 1) * hd for lo, hi in nvis)
            key_mask = torch.stack([(torch.arange(W, device=dev) >= lo)
                                    & (torch.arange(W, device=dev) <= hi)
                                    for lo, hi in nvis])[:, None, None, :]
            qh = qb.reshape(B, KV * G, 1, hd)
            record(results, dtype, "decode_attention_batch", err,
                   graph_ms(lambda: decode_attention_batch(qb, kc, vc, pt, sc,
                                                           window)),
                   graph_ms(lambda: decode_attention_batch_reference(
                       qb, kc, vc, pt, sc, window)), timing="graph",
                   cost=(nbytes, ops),
                   library_ms=library_time(
                       f"decode_attention_batch {variant}", dtype,
                       lambda: graph_ms(lambda: F.scaled_dot_product_attention(
                           qh, kc, vc, attn_mask=key_mask, enable_gqa=True))),
                   variant="" if variant == "mistral_" else variant)
            results["decode_attention_batch"][
                ("bf16_" if dtype == torch.bfloat16 else "") + variant
                + "n_split"] = plan_splits(KV, W, window, hd, dtype)
            del caches, kc, vc, qb, key_mask, qh
        torch.cuda.empty_cache()


def llama_model(cfg, dtype, **cut):
    """A seeded Llama (``lightgrad_tpu_torch.random.seed(0)``) on the card
    at ``cfg`` (``cut`` overrides fields), its parameters cast to ``dtype``
    by ``map_parameters``, one at a time (the JAX package's
    ``amp.cast_module``)."""
    from lightgrad_tpu_torch import no_grad, random as lg_random
    from lightgrad_tpu_torch.models.llama import Llama, LlamaConfig

    def cast(t):
        with no_grad():
            return t.astype(dtype)._set_requires_grad(t.requires_grad)

    lg_random.seed(0)
    model = Llama(LlamaConfig(**dict(cfg, **cut)))
    if dtype != torch.float32:
        model.map_parameters(cast)
    torch.cuda.empty_cache()
    return model


def forced_llama(model, seq, P):
    """The model's decode functions teacher-forced along ``seq``: prefill
    of seq[:P], then a cached step a token; (len - P + 1, vocab) logits."""
    fns = model._kv_functions()
    dev = model.embed_tokens.weight.device
    toks = torch.zeros(model.cfg.max_position_embeddings, dtype=torch.long)
    toks[:P] = torch.tensor(seq[:P])
    with torch.no_grad():
        cache, lg = fns.prefill(fns.init_cache(), toks.to(dev), P)
        rows = [lg]
        for pos in range(P, len(seq)):
            cache, lg = fns.step(cache, pos, seq[pos])
            rows.append(lg)
    del cache, fns
    return torch.stack(rows)


def teacher_forced_llama(model, name, dtype, P, steps=4):
    """Prefill of P random tokens, then ``steps`` cached steps, against the
    plain full-sequence forward (``plain_llama``) at PATH_TOL."""
    cfg = model.cfg
    rng = np.random.default_rng(P)
    seq = [int(t) for t in rng.integers(0, cfg.vocab_size, P + steps)]
    rows = forced_llama(model, seq, P)
    dev = model.embed_tokens.weight.device
    with torch.no_grad():
        p = {n: t.data for n, t in model.named_parameters()}
        want = plain_llama(p, cfg, torch.tensor([seq], device=dev))[0, P - 1:]
    check(f"{name} teacher-forced prefill of {P} + {steps} cached steps vs "
          f"the plain forward", dtype, rows, want, PATH_TOL[dtype])
    del rows, want
    torch.cuda.empty_cache()


# kernel-name fragment -> the family a serving call's device time is summed
# under (bf16 cuBLAS GEMMs on the H100 are nvjet_* kernels)
SERVING_FAMILIES = (("flash_fwd", "flash forward"),
                    ("decode_attention", "decode attention"),
                    ("decode_merge", "decode attention"),
                    ("nvjet", "cuBLAS GEMM"), ("gemm", "cuBLAS GEMM"),
                    ("cutlass", "cuBLAS GEMM"))


def serving_breakdown(model, name, P, slots=4, only=None):
    """Where a prefill (the prompt padded to the window), one cached step
    and one engine tick (``step_batch`` over ``slots`` slots near P) go
    (``only``: the calls whose names start so): device time by kernel
    family in one warm call of each traced by torch.profiler, against the
    call's wall time, with the kernels a call launches and its three
    costliest kernels; over a float cache the tick must launch the batched
    decode attention once a layer for all slots."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lightgrad_tpu_torch.models.decoding import stacked_zeros
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    fns = model._kv_functions()
    W, L = model.cfg.max_position_embeddings, model.cfg.num_hidden_layers
    dev = model.embed_tokens.weight.device
    toks = torch.randint(0, model.cfg.vocab_size, (W,), device=dev)
    cache = fns.init_cache()
    caches = stacked_zeros(fns.init_cache(), slots)
    poss = torch.tensor([P + 3 * b for b in range(slots)], device=dev,
                        dtype=torch.int32)
    ticks = torch.randint(0, model.cfg.vocab_size, (slots,), device=dev)
    calls = (("prefill", lambda: fns.prefill(cache, toks, P)),
             ("step", lambda: fns.step(cache, P, 7)),
             (f"engine tick (step_batch, {slots} slots)",
              lambda: fns.step_batch(caches, poss, ticks)))
    for what, call in calls:
        if only is not None and not what.startswith(only):
            continue
        call()
        torch.cuda.synchronize()
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as trace:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = launch_counts()
        fams = sorted({f for _, f in SERVING_FAMILIES}) + ["plain torch"]
        ms, n = dict.fromkeys(fams, 0.0), dict.fromkeys(fams, 0)
        by_name = {}
        for e in trace.events():
            if e.device_type == DeviceType.CUDA:
                fam = next((f for k, f in SERVING_FAMILIES if k in e.name),
                           "plain torch")
                t = e.time_range.elapsed_us() / 1e3
                ms[fam] += t
                n[fam] += 1
                by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + t
        busy = sum(ms.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        log(f"  {name} {what} (profiled): device {busy:.2f} ms of "
            f"{wall * 1e3:.2f} ms wall (idle "
            f"{100 * (1 - busy / (wall * 1e3)):.1f}%), {sum(n.values())} "
            f"kernels: "
            + ", ".join(f"{f} {t:.2f} ms ({n[f]})" for f, t in ms.items())
            + "; costliest: " + ", ".join(f"{k} {t:.2f} ms"
                                          for k, t in top))
        if what.startswith("engine tick"):
            log(f"  {name} engine tick: {sum(n.values())} launches for "
                f"{slots} slots, {wall * 1e3 / slots:.3f} ms of wall time a "
                f"token; decode_attention_batch launched "
                f"{counts['decode_attention_batch']} times for {L} layers")
            float_cache = not getattr(model, "_kv_quant", False)
            if float_cache and (counts["decode_attention_batch"] != L
                                or counts["decode_attention"]):
                raise AssertionError(f"{name}: a tick launched "
                                     f"{counts['decode_attention_batch']} "
                                     f"batched decode attentions for {L} "
                                     f"layers (and "
                                     f"{counts['decode_attention']} single)")
    del cache, caches, fns
    torch.cuda.empty_cache()


def drive_llama_serving(model, name, prompt_len, batch_lens, engine_lens):
    """``generate`` (16 new tokens after a ``prompt_len``-token prompt;
    the decode rate leaves out the prefill, timed apart as a 1-token run),
    ``generate_batch`` over ragged prompts (8 new tokens) and an
    ``InferenceEngine`` of 4 slots over 8 ragged requests, with its peak
    memory and cache bytes.  Returns the launch counts of these calls."""
    from lightgrad_tpu_torch import InferenceEngine
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    V = model.cfg.vocab_size
    rng = np.random.default_rng(11)
    prompt = [int(t) for t in rng.integers(0, V, prompt_len)]
    reset_launch_counts()
    model.generate(prompt[:8], max_new_tokens=2)    # builds, warms cuBLAS
    times = {}
    for n in (1, 16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(prompt, max_new_tokens=n)
        torch.cuda.synchronize()
        times[n] = time.perf_counter() - t0
    assert len(out) == prompt_len + 16 and all(0 <= t < V for t in out)
    per_tok = (times[16] - times[1]) / 15
    log(f"  generate: {prompt_len}-token prompt, 16 new tokens in "
        f"{times[16]:.3f} s ({16 / times[16]:.1f} tok/s with prefill; "
        f"prefill {times[1]:.3f} s; decode {per_tok * 1e3:.3f} ms/token, "
        f"{1 / per_tok:.1f} tok/s)")

    prompts = [[int(t) for t in rng.integers(0, V, n)] for n in batch_lens]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = model.generate_batch(prompts, max_new_tokens=8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert [len(o) for o in outs] == [len(p) + 8 for p in prompts]
    log(f"  generate_batch: prompts {list(batch_lens)}, 8 new tokens each in "
        f"{dt:.3f} s ({8 * len(prompts) / dt:.1f} tok/s, prefills "
        f"included)")

    reqs = [([int(t) for t in rng.integers(0, V, n)],
             int(rng.integers(4, 17))) for n in engine_lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(model, slots=4)
    handles = [engine.submit(p, n) for p, n in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert len(done) == len(reqs) and all(r.done for r in handles)
    for r, (_, n) in zip(handles, reqs):
        assert r.n_generated == n and all(0 <= t < V for t in r.tokens)
    ntok = sum(n for _, n in reqs)
    cache_mb = engine._caches.numel() * engine._caches.element_size() / 1e6
    log(f"  engine: {len(reqs)} requests (prompts {list(engine_lens)}), "
        f"{ntok} tokens in {dt:.3f} s ({ntok / dt:.1f} tok/s, "
        f"{dt * 1e3 / ntok:.3f} ms a token, prefills included; "
        f"{engine.stats}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, cache "
        f"{cache_mb:.1f} MB ({cache_mb / 4:.1f} MB a slot)")
    torch.cuda.synchronize()
    counts = launch_counts()
    del engine
    model.__dict__.pop("_kv_fns", None)
    torch.cuda.empty_cache()
    return counts


def drive_llama_device(model, name, prompt_len, slot_lens, beam):
    """The decoding module at a LLaMA model's serving context: greedy
    ``generate_device`` (LLAMA_DEVICE_NEW tokens: ``generate``'s),
    ``generate_batch_device`` over the engine's first 4 prompts (each row
    the single run's), and, where ``beam`` is (width, new tokens), beam
    search (beam 1 is greedy; the wider beam's log-prob beside greedy's).
    The device loops run under sync debug mode "error".  Returns {path:
    launch counts}."""
    from lightgrad_tpu_torch.models.decoding import beam_search

    V = model.cfg.vocab_size
    rng = np.random.default_rng(12)
    prompt = [int(t) for t in rng.integers(0, V, prompt_len)]
    N = LLAMA_DEVICE_NEW
    counts = {}
    want = model.generate(prompt, max_new_tokens=N)
    got, io = path_run(counts, "generate_device", lambda: sync_free(
        lambda: model.generate_device(prompt, N)))
    if got != want:
        raise AssertionError(f"{name}: generate_device's greedy tokens "
                             f"differ from generate's")
    prompts = [[int(t) for t in rng.integers(0, V, n)] for n in slot_lens[:4]]
    got_b, io_b = path_run(counts, "generate_batch_device", lambda: sync_free(
        lambda: model.generate_batch_device(prompts, LLAMA_BATCH_NEW)))
    near = sum(same_greedy(f"{name} generate_batch_device row {i}", model, g,
                           model.generate_device(p, LLAMA_BATCH_NEW), len(p),
                           PATH_TOL[torch.bfloat16])
               for i, (p, g) in enumerate(zip(prompts, got_b)))
    log(f"  generate_device: {N} greedy tokens after {prompt_len} equal "
        f"generate's (host transfers {io}); generate_batch_device over "
        f"prompts {list(slot_lens[:4])}, {LLAMA_BATCH_NEW} tokens each: "
        f"{len(prompts) - near} rows equal the single runs, {near} first "
        f"differ at a near-tie (host transfers {io_b})")
    if beam:
        width, n = beam
        if beam_search(model, prompt, n, beam_size=1) != want[:prompt_len + n]:
            raise AssertionError(f"{name}: beam 1 differs from greedy")
        out, _ = path_run(counts, "beam_search", lambda: beam_search(
            model, prompt, n, beam_size=width))
        lp_b = seq_logprob(model, out, prompt_len)
        lp_g = seq_logprob(model, want[:prompt_len + n], prompt_len)
        log(f"  beam_search, {n} tokens: beam 1 equals greedy; beam {width} "
            f"log-prob {lp_b:.4f}, greedy {lp_g:.4f} (a record: a narrow "
            f"beam may prune greedy's prefix)")
    torch.cuda.empty_cache()
    return counts, prompt


def phase_llama_serving(card):
    """Serving at the published widths, bfloat16, seeded random weights:
    Mistral-7B (16 of 32 layers, MISTRAL_SERVING_LAYERS;
    max_position_embeddings cut from 32768 to 8192,
    the cache window and the prefill length) with a 4500-token prompt, so
    prefill and decode run past the 4096 band, and Gemma-2B (18 layers, W
    8192, no cut) with a 1000-token prompt: ``generate``,
    ``generate_batch``, an engine, and the teacher-forced check against the
    plain forward; then each model's int8 modes (phase 9e,
    :func:`phase_llama_int8`); then Mistral-7B's check in float32 at 4
    layers.  Returns ({path: launch counts}, {(model, mode, path): launch
    counts} of the int8 paths)."""
    counts, int8 = {}, {}
    for name, cfg, P, batch_lens, engine_lens in LLAMA_SERVING:
        depth = MISTRAL_SERVING_LAYERS if name == "Mistral-7B" \
            else cfg["num_hidden_layers"]
        log(f"serving path, {name}, bfloat16, {depth} of "
            f"{cfg['num_hidden_layers']} layers (W "
            f"{cfg['max_position_embeddings']}):")
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = llama_model(cfg, torch.bfloat16, num_hidden_layers=depth)
        n = sum(t.numel() for t in model.parameters())
        log(f"  {n / 1e9:.3f} B parameters, "
            f"{n * 2 / 1e9:.2f} GB in bf16; built in "
            f"{time.perf_counter() - t0:.1f} s (peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
        counts[name] = drive_llama_serving(model, name, P, batch_lens,
                                           engine_lens)
        t1 = time.perf_counter()
        paths, prompt = drive_llama_device(
            model, name, P, engine_lens, LLAMA_BEAM if name == "Gemma-2B"
            else None)
        for path, c in paths.items():
            counts[f"{name} {path}"] = c
        decode_rates(model, name, prompt, LLAMA_DEVICE_NEW, card)
        model.__dict__.pop("_kv_fns", None)
        log(f"  {name} decoding module: {time.perf_counter() - t1:.1f} s")
        serving_breakdown(model, name, P)
        teacher_forced_llama(model, name, torch.bfloat16, P)
        log(f"int8 serving, {name}:")
        for (mode, path), c in phase_llama_int8(model, name, P, card).items():
            int8[(name, mode, path)] = c
        del model
        torch.cuda.empty_cache()
        log(f"  {name} serving phase: {time.perf_counter() - t0:.1f} s")
    log("serving path, Mistral-7B, float32, 4 layers (the teacher-forced "
        "check):")
    _, cfg, P, _, _ = LLAMA_SERVING[0]
    model = llama_model(cfg, torch.float32, num_hidden_layers=4)
    teacher_forced_llama(model, "Mistral-7B (4 layers)", torch.float32, P)
    del model
    torch.cuda.empty_cache()
    return counts, int8


def twin_checked_steps(name, model, plain, B, S, lr, card):
    """BERT_STEPS AdamW steps of a tape language model on one batch of B x S
    random tokens (``tape_steps``), step 1's logits and every parameter's
    gradient held against ``plain(params, cfg, ids)`` under torch autograd
    (the twin's gradients are dropped once checked, before the steps whose
    peak memory is reported).  Returns the steps' launch counts."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch.autograd import Tensor

    t0 = time.perf_counter()
    mcfg = model.cfg
    n = sum(t.numel() for t in model.parameters())
    V = mcfg.vocab_size
    ids = np.random.default_rng(12).integers(0, V, (B, S + 1)) \
        .astype(np.int32)
    dev = torch.device("cuda")
    params = {k: t.data.detach().requires_grad_(True)
              for k, t in model.named_parameters()}
    logits = plain(params, mcfg, torch.tensor(ids[:, :-1], device=dev).long())
    loss = F.cross_entropy(logits.reshape(B * S, V),
                           torch.tensor(ids[:, 1:].reshape(-1),
                                        device=dev).long())
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))
    plain_logits, plain_loss = logits.detach(), loss.item()
    del params, logits, loss
    torch.cuda.empty_cache()
    log(f"  {n / 1e9:.3f} B parameters; plain twin step 1 in "
        f"{time.perf_counter() - t0:.1f} s")

    def check_step1(logits, loss):
        check(f"{name} logits vs the plain twin", torch.float32,
              logits.data, plain_logits, PATH_TOL[torch.float32])
        log(f"  step-1 loss {loss.item():.5f}, plain twin {plain_loss:.5f}")
        tape_grad_check(model, grads)
        grads.clear()

    opt = optim.AdamW(list(model.parameters()), lr=lr)
    return tape_steps(
        model, opt, Tensor.from_numpy(ids[:, :-1], requires_grad=False),
        Tensor.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False),
        card, check_step1)


def phase_llama_train(card):
    """Training on the tape, float32, AdamW, LLAMA_STEPS steps on one batch
    at full width cut to 2 layers: Mistral-7B on 1 x 8192 tokens (the
    window active) and Gemma-2B on 2 x 1024 (head dim 256).  Step 1's
    logits and every parameter's gradient against the plain twin
    (``plain_llama`` under torch autograd); the loss must be finite and
    fall.  Returns {name: launch counts}."""
    counts = {}
    for name, cfg, B, S in LLAMA_TRAINING:
        log(f"training on the tape, {name} (2 of {cfg['num_hidden_layers']} "
            f"layers), {B} x {S} tokens, float32, AdamW:")
        t0 = time.perf_counter()
        model = llama_model(cfg, torch.float32, num_hidden_layers=2)
        counts[name] = twin_checked_steps(name, model, plain_llama, B, S,
                                          LLAMA_LR, card)
        del model
        torch.cuda.empty_cache()
        log(f"  {name} training phase: {time.perf_counter() - t0:.1f} s")
    return counts


def phase_neox_kernels(results):
    """Phase 3, the fused flash backward at every head dim: Pythia-1B's
    attention, 2 x 8 heads of 2048 x 256 (the D 256 instantiation, 64 key
    rows a block), Pythia-2.8B's, 32 heads of 2048 x 80 (f32: D 96's 128
    rows at row stride 80; bf16: D 128's 64), and D 32 at 64 heads of 256 x
    32, causal, each
    by :func:`fused_bwd_case`, timed with the two passes on the same
    inputs; correctness only at head dims 200 and 80 without the causal
    mask, S no multiple of the block's rows."""
    g = torch.Generator(device="cuda").manual_seed(21)
    # (variant, batch, heads, S, hd, causal, timed): the training phase's
    # batches over the models' full context
    (_, p1, _, b1, s1), (_, p28, _, b28, s28) = NEOX_TRAINING
    cases = (("pythia1b_", b1, p1["num_attention_heads"], s1,
              p1["hidden_size"] // p1["num_attention_heads"], True, True),
             ("pythia2p8b_", b28, p28["num_attention_heads"], s28,
              p28["hidden_size"] // p28["num_attention_heads"], True, True),
             ("d32_", 4, 16, 256, 32, True, True),
             ("", 1, 8, 300, 200, False, False),
             ("", 2, 4, 129, 80, False, False))
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            fused_bwd_case(results, dtype, g, *case[1:], variant=case[0])


def plain_neox(p, cfg, ids):
    """Logits (b, T, vocab) of ``NeoX.forward`` through the plain PyTorch
    versions of the kernels (``_reference``), differentiable by torch
    autograd, attention one head at a time (``_PlainAttention``): the twin
    of the tape's step and of ``generate``.  Its partial-RoPE tables are its
    own: pair i of the first ``rot`` dims of position t turns by t *
    base^(-2i / rot), in numpy f32 arithmetic as the model's; the other
    dims pass through."""
    from lightgrad_tpu_torch.ops.elementwise import ew_reference
    from lightgrad_tpu_torch.ops.layernorm import layernorm_fwd_reference
    from lightgrad_tpu_torch.ops.matmul import matmul_reference

    b, T = ids.shape
    H = cfg.num_attention_heads
    hd = cfg.hidden_size // H
    rot = int(hd * cfg.rotary_pct)
    emb = p["embed_in.weight"]
    pair = np.arange(rot // 2, dtype=np.float32)
    turn = np.float32(1.0) / np.float32(cfg.rotary_emb_base) ** (
        2 * pair / np.float32(rot))
    ang = np.arange(T, dtype=np.float32)[:, None] * turn
    ang = np.concatenate([ang, ang], -1)      # x1 and x2 share pair i's angle
    cos, sin = (torch.from_numpy(f(ang)).to(device=emb.device,
                                            dtype=emb.dtype)
                for f in (np.cos, np.sin))

    def ln(x, name):
        return layernorm_fwd_reference(x, p[name + ".weight"],
                                       p[name + ".bias"],
                                       cfg.layer_norm_eps)[0]

    def lin(x, name):
        y = matmul_reference(x, p[name + ".weight"].T)
        bias = p.get(name + ".bias")
        return y if bias is None else y + bias

    def silu(g):
        return torch.sigmoid(g) * g

    def rope(x):
        xr = x[..., :rot]
        x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
        return torch.cat([xr * cos + torch.cat([-x2, x1], -1) * sin,
                          x[..., rot:]], -1)

    def attn(h, pre):
        qkv = lin(h, pre + "attention.query_key_value")
        qkv = qkv.reshape(b, T, H, 3 * hd).transpose(1, 2)
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        att = _PlainAttention.apply(rope(q), rope(k), v, hd ** -0.5, 0,
                                    True)
        return lin(att.transpose(1, 2).reshape(b, T, H * hd),
                   pre + "attention.dense")

    def mlp(h, pre):
        a = ew_reference("f_gelu_exact", lin(h, pre + "mlp.dense_h_to_4h"))
        return lin(a, pre + "mlp.dense_4h_to_h")

    x = emb[ids]
    for l in range(cfg.num_hidden_layers):
        pre = f"layers.{l}."
        if cfg.use_parallel_residual:
            x = (x + attn(ln(x, pre + "input_layernorm"), pre)
                 + mlp(ln(x, pre + "post_attention_layernorm"), pre))
        else:
            x = x + attn(ln(x, pre + "input_layernorm"), pre)
            x = x + mlp(ln(x, pre + "post_attention_layernorm"), pre)
    return matmul_reference(ln(x, "final_layer_norm"),
                            p["embed_out.weight"].T)


def neox_model(cfg, **cut):
    """A seeded NeoX (``lightgrad_tpu_torch.random.seed(0)``) on the card,
    float32, at ``cfg`` (``cut`` overrides fields)."""
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.models.neox import NeoX, NeoXConfig

    lg_random.seed(0)
    return NeoX(NeoXConfig(**dict(cfg, **cut)))


def phase_neox_train(card):
    """Training on the tape with the fused flash backward
    (``set_flash_fused(True)``), float32, AdamW, 5 steps on one batch at
    full width: Pythia-1B (all 16 layers, head dim 256) on 2 x 2048 tokens
    and Pythia-2.8B (2 of 32 layers, head dim 80) on 1 x 2048.  Step 1's
    logits and every parameter's gradient against the plain twin
    (``plain_neox`` under torch autograd); the loss must be finite and
    fall, and the steps must not launch the two passes.  Returns {name:
    launch counts}."""
    from lightgrad_tpu_torch.ops.attention import set_flash_fused

    counts = {}
    for name, cfg, L, B, S in NEOX_TRAINING:
        log(f"training on the tape, {name} ({L} of "
            f"{cfg['num_hidden_layers']} layers), {B} x {S} tokens, float32, "
            f"AdamW, fused flash backward:")
        t0 = time.perf_counter()
        model = neox_model(cfg, num_hidden_layers=L)
        prev = set_flash_fused(True)
        try:
            counts[name] = twin_checked_steps(name, model, plain_neox, B, S,
                                              NEOX_LR, card)
        finally:
            set_flash_fused(prev)
        if counts[name]["attention_bwd_dq"] or \
                counts[name]["attention_bwd_dkv"]:
            raise AssertionError(f"{name}: the fused step launched the two "
                                 f"passes")
        del model
        torch.cuda.empty_cache()
        log(f"  {name} training phase: {time.perf_counter() - t0:.1f} s")
    return counts


def phase_neox_generate(card):
    """Pythia-1B (all 16 layers, seeded random weights, float32) greedy
    ``generate``: a NEOX_PROMPT-token prompt and NEOX_NEW new tokens, each a
    full forward of the 2048-token padded window on the tape.  Each new
    token must be the argmax of the plain twin's logits on the same padded
    window, and the tape's logits of the last window must match the twin's
    at PATH_TOL.  Returns the launch counts of ``generate``."""
    from lightgrad_tpu_torch import no_grad
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    model = neox_model(PYTHIA_1B)
    cfg, dev = model.cfg, torch.device("cuda")
    W = cfg.max_position_embeddings
    prompt = [int(t) for t in np.random.default_rng(15).integers(
        0, cfg.vocab_size, NEOX_PROMPT)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=NEOX_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    log(f"  generate: {NEOX_NEW} tokens after a {NEOX_PROMPT}-token prompt "
        f"in {dt:.2f} s ({dt / NEOX_NEW * 1e3:.1f} ms a token, each a "
        f"{W}-token forward); {card}")
    p = {k: t.data for k, t in model.named_parameters()}
    gaps = []
    with torch.no_grad():
        for i in range(NEOX_NEW):
            ctx = out[:NEOX_PROMPT + i]
            window = np.zeros((1, W), np.int32)
            window[0, :len(ctx)] = ctx
            logits = plain_neox(p, cfg, torch.tensor(window, device=dev)
                                .long())[0]
            row = logits[len(ctx) - 1]
            top2 = row.topk(2).values
            gaps.append((top2[0] - top2[1]).item())
            if int(row.argmax()) != out[len(ctx)]:
                raise AssertionError(
                    f"Pythia-1B generate: token {i} is {out[len(ctx)]}, the "
                    f"twin's argmax {int(row.argmax())}")
    # the last window's real rows: the tape's forward against the twin's
    rows = slice(NEOX_PROMPT - 1, NEOX_PROMPT + NEOX_NEW - 1)
    with no_grad():
        got = model(Tensor.from_numpy(window, requires_grad=False))
    check(f"Pythia-1B generate's last window, rows {rows.start}-"
          f"{rows.stop - 1}, vs the plain twin", torch.float32,
          got.data[0, rows], logits[rows], PATH_TOL[torch.float32])
    log(f"  tokens {out[NEOX_PROMPT:]} equal the twin's argmax at every "
        f"step (smallest top-2 gap {min(gaps):.3e})")
    del p, got, logits
    # phase 16's recompute decode: generate's window forward is compiled
    # (``_decode_fn``); again, all replays, against the eager forward
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = model.generate(prompt, max_new_tokens=NEOX_NEW)
    torch.cuda.synchronize()
    dt_again = time.perf_counter() - t0
    eager = list(prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NEOX_NEW):
        window = np.zeros((1, W), np.int32)
        window[0, :len(eager)] = eager
        with no_grad():
            row = model(Tensor.from_numpy(window, requires_grad=False))[
                0, len(eager) - 1].numpy()
        eager.append(int(np.argmax(row)))
    dt_eager = time.perf_counter() - t0
    log(f"  step compiler: generate's compiled window forward "
        f"{dt_again / NEOX_NEW * 1e3:.1f} ms a token (all replays; the first"
        f" call with record and capture {dt / NEOX_NEW * 1e3:.1f}), eager "
        f"{dt_eager / NEOX_NEW * 1e3:.1f} ms a token; tokens compiled "
        f"{'==' if again == eager == out else '!='} eager; {card}")
    if not again == eager == out:
        raise AssertionError(f"Pythia-1B compiled decode {again[NEOX_PROMPT:]}"
                             f" vs eager {eager[NEOX_PROMPT:]}")
    del model
    torch.cuda.empty_cache()
    return counts


def dequantized_llama(model):
    """The parameters of a ``quantize_serving`` LLaMA with each int8
    matrix replaced by its dequantized value (int8 x scale, in the compute
    dtype) and the tied head's int8 copy as "head.weight"."""
    qp = model._kv_functions().step.params
    p = {n: t.data for n, t in model.named_parameters()}
    cdt = model.embed_tokens.weight.dtype
    for n in [n for n in qp if n.endswith("#q")]:
        base = n[:-2]
        w = (qp[n].float() * qp[base + "#s"].float()[:, None]).to(cdt)
        p["head.weight" if base == "head" else base] = w
    return p


def routing_check(name, serving, plain):
    """Routing of the decode functions against the plain forward's, a
    layer at a time: ``serving`` and ``plain`` hold each layer's (probs
    (T, E), ids (T, k)) over the same T positions.  A position is decisive
    where the plain k-th and (k+1)-th probabilities are more than 10x the
    row's deviation apart: there the two must choose the same set."""
    n_dec = n_rows = 0
    worst = 0.0
    for l, ((sp, sid), (pp, pid)) in enumerate(zip(serving, plain)):
        k = pid.shape[-1]
        dev = (sp - pp).abs().amax(-1)
        top = pp.topk(k + 1, -1).values
        decisive = (top[:, k - 1] - top[:, k]) > 10 * dev.clamp_min(1e-7)
        same = (sid.sort(-1).values == pid.sort(-1).values).all(-1)
        bad = decisive & ~same
        n_dec += int(decisive.sum())
        n_rows += len(dev)
        worst = max(worst, dev.max().item())
        if bad.any():
            raise AssertionError(f"{name}: layer {l} routes "
                                 f"{int(bad.sum())} decisive positions to "
                                 f"other experts than the plain forward")
    log(f"  {name} routing: {n_dec} of {n_rows} (position, layer) routings "
        f"decisive, all the plain forward's experts; max probability "
        f"deviation {worst:.3e}")


def forced_routes(model, seq, P):
    """:func:`forced_llama` with the routing of its prefill and steps
    recorded: (logits, [(probs (T, E), ids (T, k)) a layer]) over the T =
    len(seq) positions, the prefill's P rows first."""
    from lightgrad_tpu_torch.models import llama as llama_mod

    calls = []
    topk_gates = llama_mod.topk_gates

    def recorded(probs, k):
        gates, ids = topk_gates(probs, k)
        calls.append((probs, ids))
        return gates, ids

    llama_mod.topk_gates = recorded
    try:
        # eager: a replayed graph would call nothing to record
        with eager_decoding():
            got = forced_llama(model, seq, P)
    finally:
        llama_mod.topk_gates = topk_gates
    L, steps = model.cfg.num_hidden_layers, len(seq) - P
    # the prefill's L calls over the window (its P prompt rows kept), then
    # L a step
    return got, [tuple(torch.cat([calls[l][i][:P]]
                                 + [calls[L * (1 + j) + l][i]
                                    for j in range(steps)])
                       for i in (0, 1)) for l in range(L)]


def forced_vs_plain(model, name, what, seq, P, p, kv_from=None):
    """The decode functions teacher-forced along ``seq`` (prefill of P,
    then a cached step a token) against ``plain_llama`` over ``p`` at
    PATH_TOL.  With experts the plain forward takes the model's recorded
    experts, so the two compute the same function, and the model's
    choices are held to the plain forward's own where they are decisive
    (:func:`routing_check`).  Returns (got, want)."""
    cfg = model.cfg
    serving = None
    if cfg.num_local_experts:
        got, serving = forced_routes(model, seq, P)
    else:
        got = forced_llama(model, seq, P)
    routes = []
    with torch.no_grad():
        want = plain_llama(p, cfg, torch.tensor(
            [seq], device=model.embed_tokens.weight.device), routes=routes,
            kv_from=kv_from,
            route_ids=serving and [ids for _, ids in serving])[0, P - 1:]
    check(f"{name} {what}", torch.bfloat16, got, want,
          PATH_TOL[torch.bfloat16])
    if serving:
        routing_check(name, serving, routes)
    return got, want


def teacher_forced_mixtral(model, name, P, steps=4):
    """Prefill of P random tokens and ``steps`` cached steps against the
    plain full-sequence forward (``plain_llama`` with ``plain_moe``),
    :func:`forced_vs_plain`."""
    rng = np.random.default_rng(P)
    seq = [int(t) for t in rng.integers(0, model.cfg.vocab_size, P + steps)]
    p = {n: t.data for n, t in model.named_parameters()}
    forced_vs_plain(model, name, f"teacher-forced prefill of {P} + {steps} "
                    f"cached steps vs the plain forward", seq, P, p)
    torch.cuda.empty_cache()


def decode_ms(model, prompt, n=INT8_NEW):
    """Wall ms a token of greedy ``generate`` after ``prompt``: runs of 1
    and ``n`` new tokens, the difference over n - 1, after two runs of 1
    that record and capture the prompt's compiled prefill."""
    for _ in range(2):
        model.generate(prompt, max_new_tokens=1)
    wall = []
    for k in (1, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(prompt, max_new_tokens=k)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return (wall[1] - wall[0]) * 1e3 / (n - 1)


def cache_bytes(cache):
    return sum(c.numel() * c.element_size()
               for c in (cache if isinstance(cache, tuple) else (cache,)))


def drive_engine(model, name, lens, new):
    """An ``InferenceEngine`` of 4 slots over ragged greedy requests under
    sync debug mode "error" (its transfers are the decoding module's
    counted ones); each request's tokens against a single ``generate``
    (or a near-tie of its logits).  Returns the run's launch counts."""
    from lightgrad_tpu_torch import InferenceEngine
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    V = model.cfg.vocab_size
    rng = np.random.default_rng(len(lens))
    reqs = [([int(t) for t in rng.integers(0, V, n)], new(i))
            for i, n in enumerate(lens)]
    engine = InferenceEngine(model, slots=4)
    handles = [engine.submit(p, n) for p, n in reqs]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    sync_free(engine.run)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    ntok = sum(n for _, n in reqs)
    near = 0
    for i, (r, (p, n)) in enumerate(zip(handles, reqs)):
        assert r.done and r.n_generated == n, (name, i)
        near += same_greedy(f"{name} engine request {i}", model, r.tokens,
                            model.generate(p, max_new_tokens=n), len(p),
                            PATH_TOL[torch.bfloat16])
    log(f"  {name} engine: {len(reqs)} requests on 4 slots, {ntok} tokens "
        f"in {dt:.3f} s ({ntok / dt:.1f} tok/s, prefills included; "
        f"{engine.stats}); cache {cache_bytes(engine._caches) / 1e6:.1f} MB"
        f"; {len(reqs) - near} requests equal generate's, {near} differ "
        f"first at a near-tie")
    del engine
    return counts


def phase_mixtral_serving(card):
    """Phase 9d: Mixtral-8x7B at its published widths, cut to 8 of 32
    layers and W 4096, bf16, seeded random weights: greedy ``generate`` of
    MIXTRAL_NEW tokens after a MIXTRAL_PROMPT-token prompt, ``generate_device``
    (its tokens ``generate``'s), ``generate_batch_device`` over 4 ragged
    prompts and an engine of 4 slots over 8 requests, each under sync debug
    mode "error"; wall and device ms a token, the idle share, a step's
    launches and expert bytes, peak memory; the teacher-forced check with
    the routing against the plain forward.  Then phase 9e's int8 modes of
    the same model.  Returns (model, {path: launch counts})."""
    name = "Mixtral-8x7B"
    log(f"serving path, {name}, bfloat16, {MIXTRAL_CUT['num_hidden_layers']}"
        f" of {MIXTRAL_8X7B['num_hidden_layers']} layers (W "
        f"{MIXTRAL_CUT['max_position_embeddings']}, cut from "
        f"{MIXTRAL_8X7B['max_position_embeddings']}):")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = llama_model(MIXTRAL_8X7B, torch.bfloat16, **MIXTRAL_CUT)
    cfg = model.cfg
    n = sum(t.numel() for t in model.parameters())
    log(f"  {n / 1e9:.3f} B parameters, {n * 2 / 1e9:.2f} GB in bf16; built "
        f"in {time.perf_counter() - t0:.1f} s (peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    counts = {}
    V, P, N = cfg.vocab_size, MIXTRAL_PROMPT, MIXTRAL_NEW
    rng = np.random.default_rng(13)
    prompt = [int(t) for t in rng.integers(0, V, P)]
    torch.cuda.reset_peak_memory_stats()
    model.generate(prompt[:8], max_new_tokens=2)     # builds, warms cuBLAS
    want, _ = path_run(counts, "generate", lambda: model.generate(
        prompt, max_new_tokens=N))
    got, io = path_run(counts, "generate_device", lambda: sync_free(
        lambda: model.generate_device(prompt, N)))
    if got != want:
        raise AssertionError(f"{name}: generate_device's greedy tokens "
                             f"differ from generate's")
    prompts = [[int(t) for t in rng.integers(0, V, k)] for k in MIXTRAL_BATCH]
    got_b, io_b = path_run(counts, "generate_batch_device", lambda: sync_free(
        lambda: model.generate_batch_device(prompts, LLAMA_BATCH_NEW)))
    near = sum(same_greedy(f"{name} generate_batch_device row {i}", model, g,
                           model.generate(pr, max_new_tokens=LLAMA_BATCH_NEW),
                           len(pr), PATH_TOL[torch.bfloat16])
               for i, (pr, g) in enumerate(zip(prompts, got_b)))
    log(f"  generate_device: {N} greedy tokens after {P} equal generate's "
        f"(host transfers {io}); generate_batch_device over prompts "
        f"{list(MIXTRAL_BATCH)}, {LLAMA_BATCH_NEW} tokens each: "
        f"{len(prompts) - near} rows equal generate's, {near} first differ "
        f"at a near-tie (host transfers {io_b})")
    counts["engine"] = drive_engine(model, name, MIXTRAL_ENGINE,
                                    lambda i: int(rng.integers(4, 17)))
    log(f"  peak memory of the serving calls "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    decode_rates(model, name, prompt, N, card)
    d, ff, k = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts_per_tok
    L, E = cfg.num_hidden_layers, cfg.num_local_experts
    stack = 3 * d * ff * 2
    log(f"  expert bytes of a step or an engine tick: all {E} stacks a "
        f"layer read in place by batched products, {E * stack / 1e6:.1f} MB"
        f", {E * stack * L / 1e9:.2f} GB over {L} layers (the {k} chosen "
        f"stacks alone: {k * stack * L / 1e9:.2f} GB)")
    serving_breakdown(model, name, P)
    model.__dict__.pop("_kv_fns", None)
    teacher_forced_mixtral(model, name, P)
    log(f"  {name} serving phase: {time.perf_counter() - t0:.1f} s")
    return model, counts


def teacher_forced_llama_int8(model, name, mode, P, steps=8):
    """Prefill of P tokens + ``steps`` cached steps against the plain
    forward in the same mode (:func:`forced_vs_plain`): over the
    dequantized weights under int8 weights, and under an int8 cache with
    each K/V row quantized and dequantized by the cache's rule where the
    model attends it so (``plain_llama``'s ``kv_from``); the greedy tokens
    by the decisive-gap rule of phase 4 besides."""
    cfg = model.cfg
    rng = np.random.default_rng(P + 1)
    seq = [int(t) for t in rng.integers(0, cfg.vocab_size, P + steps)]
    model.__dict__.pop("_kv_fns", None)
    kv_from = None
    if mode != "quantize_serving":
        kv_from = 0 if cfg.num_local_experts else P
    p = (dequantized_llama(model) if mode != "quantize_kv" else
         {n: t.data for n, t in model.named_parameters()})
    what = {"quantize_serving": "the dequantized plain forward",
            "quantize_kv": "the plain forward over int8 K/V rows",
            "both": "the dequantized plain forward over int8 K/V rows"}[mode]
    got, want = forced_vs_plain(model, f"{name} {mode}",
                                f"teacher-forced vs {what}", seq, P, p,
                                kv_from)
    decisive_tokens(f"{name} teacher-forced {mode} vs {what}", got, want)
    del got, want, p
    torch.cuda.empty_cache()


def int8_path_kernels(mode, path):
    """The kernels an int8 serving path must launch: the prefill's flash
    forward, and decode attention over a float cache (an int8 cache is
    attended in plain PyTorch, as the JAX package does)."""
    if mode != "quantize_serving":
        return ("attention_fwd",)
    return ("attention_fwd", "decode_attention_batch" if path == "engine"
            else "decode_attention")


def phase_llama_int8(model, name, P, card):
    """Phase 9e for one model: each of its LLAMA_INT8_MODES runs
    ``generate`` (INT8_NEW tokens after P), ``generate_device`` (its tokens
    ``generate``'s, under sync debug mode "error") and an engine of 4 slots
    over INT8_ENGINE requests; weight and cache bytes, ms a token beside the
    bf16 model's, the teacher-forced check.  Returns {(mode, path):
    launch counts}."""
    counts = {}
    V = model.cfg.vocab_size
    rng = np.random.default_rng(14)
    prompt = [int(t) for t in rng.integers(0, V, P)]
    floats = sum(t.data.numel() * t.data.element_size()
                 for t in model.parameters())
    model.generate(prompt[:8], max_new_tokens=2)
    bf16_ms = decode_ms(model, prompt)
    model.__dict__.pop("_kv_fns", None)
    for mode in LLAMA_INT8_MODES[name]:
        t0 = time.perf_counter()
        model.quantize_serving(mode != "quantize_kv")
        model.quantize_kv(mode != "quantize_serving")
        fns = model._kv_functions()
        model._kv_fns = fns
        pw = fns.step.params
        wbytes = sum(t.numel() * t.element_size() for t in pw.values())
        cb = cache_bytes(fns.init_cache())
        model.generate(prompt[:8], max_new_tokens=2)
        ms = decode_ms(model, prompt)
        runs = {}
        want, _ = path_run(runs, "generate", lambda: model.generate(
            prompt, max_new_tokens=INT8_NEW))
        got, io = path_run(runs, "generate_device", lambda: sync_free(
            lambda: model.generate_device(prompt, INT8_NEW)))
        if got != want:
            raise AssertionError(f"{name} {mode}: generate_device's greedy "
                                 f"tokens differ from generate's")
        runs["engine"] = drive_engine(model, f"{name} {mode}",
                                      MIXTRAL_ENGINE[:INT8_ENGINE],
                                      lambda i: 8)
        counts.update({(mode, path): c for path, c in runs.items()})
        log(f"  {name} {mode}: decode weights {wbytes / 1e9:.2f} GB (float "
            f"{floats / 1e9:.2f} GB), cache {cb / 1e6:.1f} MB a sequence; "
            f"generate {ms:.3f} ms a token after {P} (bf16: {bf16_ms:.3f}); "
            f"generate_device's {INT8_NEW} tokens equal generate's (host "
            f"transfers {io}); {card}")
        del fns, pw
        serving_breakdown(model, f"{name} {mode}", P, only="step")
        model.__dict__.pop("_kv_fns", None)
        teacher_forced_llama_int8(model, name, mode, P)
        log(f"  {name} {mode}: {time.perf_counter() - t0:.1f} s")
    model.quantize_serving(False)
    model.quantize_kv(False)
    return counts


def plain_mixtral_step(model, ids):
    """Step 1 of the plain twin: logits, aux loss, loss (cross-entropy +
    MIXTRAL_AUX x aux) and every parameter's gradient under torch autograd,
    on the tape model's current weights."""
    import torch.nn.functional as F

    cfg = model.cfg
    params = {k: t.data.detach().requires_grad_(True)
              for k, t in model.named_parameters()}
    aux = []
    logits = plain_llama(params, cfg, ids[:, :-1], aux=aux)
    B, S = ids.shape[0], ids.shape[1] - 1
    aux = sum(aux)
    loss = F.cross_entropy(logits.reshape(B * S, -1),
                           ids[:, 1:].reshape(-1)) + MIXTRAL_AUX * aux
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    return logits.detach(), aux.item(), loss.item(), grads


def phase_mixtral_train(card):
    """Phase 9f (i): Mixtral-8x7B's widths cut to 1 layer, MIXTRAL_TRAIN
    (batch, sequence, steps) on the tape: f32 AdamW, step 1's logits,
    ``aux_loss`` and every gradient held to the plain twin; then bf16
    ``MixedPrecision`` AdamW on the same weights, whose loss must be
    finite and fall.  Returns {name: launch counts}."""
    from lightgrad_tpu_torch import amp, optim
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    B, S, steps = MIXTRAL_TRAIN
    name = "Mixtral-8x7B (1 layer)"
    log(f"training on the tape, {name}, {B} x {S} tokens, float32 AdamW, "
        f"then bfloat16 MixedPrecision AdamW; loss cross-entropy + "
        f"{MIXTRAL_AUX} aux:")
    t0 = time.perf_counter()
    model = llama_model(MIXTRAL_8X7B, torch.float32, num_hidden_layers=1,
                        max_position_embeddings=S)
    n = sum(t.numel() for t in model.parameters())
    V = model.cfg.vocab_size
    dev = model.embed_tokens.weight.device
    ids = torch.tensor(np.random.default_rng(15).integers(0, V, (B, S + 1)),
                       device=dev)
    x = Tensor(ids[:, :-1].int(), requires_grad=False)
    y = Tensor(ids[:, 1:].reshape(-1).int(), requires_grad=False)
    plain_logits, plain_aux, plain_loss, grads = plain_mixtral_step(model,
                                                                    ids)
    torch.cuda.empty_cache()
    log(f"  {n / 1e9:.3f} B parameters; plain twin step 1 in "
        f"{time.perf_counter() - t0:.1f} s")

    def loss_of(logits):
        return lg_loss.cross_entropy(logits.reshape(B * S, V), y) \
            + model.aux_loss * MIXTRAL_AUX

    counts = {}
    for what in ("float32 AdamW", "bfloat16 MixedPrecision AdamW"):
        if what.startswith("float32"):
            opt = optim.AdamW(list(model.parameters()), lr=LLAMA_LR)
            zero, scale, step = opt.zero_grad, (lambda l: l), opt.step
        else:
            del opt, zero, step
            torch.cuda.empty_cache()
            mp = amp.MixedPrecision(model, lambda ps: optim.AdamW(
                ps, lr=LLAMA_LR))
            zero, scale, step = mp.zero_grad, mp.scale, mp.step
            before = mp.masters[0].data.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, times = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = model(x)
            loss = loss_of(logits)
            zero()
            scale(loss).backward()
            if i == 0 and what.startswith("float32"):
                torch.cuda.synchronize()
                c0 = time.perf_counter()
                check(f"{name} logits vs the plain twin", torch.float32,
                      logits.data, plain_logits, PATH_TOL[torch.float32])
                check(f"{name} aux_loss vs the plain twin", torch.float32,
                      model.aux_loss.data.reshape(1),
                      torch.tensor([plain_aux], device=dev),
                      PATH_TOL[torch.float32])
                log(f"  step-1 loss {loss.item():.5f}, plain twin "
                    f"{plain_loss:.5f}")
                tape_grad_check(model, grads)
                grads.clear()
                torch.cuda.reset_peak_memory_stats()
                t1 += time.perf_counter() - c0
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(loss.item())
            del logits, loss
        counts[f"{name}, {what}"] = launch_counts()
        ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
        log(f"  {what}: losses {[round(v, 4) for v in losses]} "
            f"({'finite, falling' if ok else 'FAIL'}); step ms "
            f"{[round(t * 1e3, 1) for t in times]} (median of steps 2-"
            f"{steps} {np.median(times[1:]) * 1e3:.1f}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
        if not ok:
            raise AssertionError(f"{name} {what}: loss not finite and "
                                 f"falling: {losses}")
    if torch.equal(mp.masters[0].data, before):
        raise AssertionError(f"{name}: MixedPrecision's masters did not move")
    del model, mp
    torch.cuda.empty_cache()
    log(f"  {name} training phase: {time.perf_counter() - t0:.1f} s")
    return counts


def phase_amp_one_step(card):
    """Phase 9f (iii): one bf16 ``MixedPrecision`` AdamW step of BERT-base
    (phase 6's masked-LM batch) and of ResNet-18 (phase 8's 32 x 224²
    batch): the loss is finite and every master moves.  Returns {name:
    launch counts}."""
    from lightgrad_tpu_torch import amp, optim, random as lg_random
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models import resnet18
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.autograd.cuda.device import default_device
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = default_device()
    lg_random.seed(0)
    cfg = BertConfig(**BERT_BASE)
    ids, mask, labels, _ = bert_batch(cfg)
    bert = (BertForMaskedLM(cfg), BERT_LR, lambda m: lg_loss.cross_entropy(
        m(Tensor(torch.tensor(ids, device=dev), requires_grad=False),
          attention_mask=Tensor(torch.tensor(mask, device=dev),
                                requires_grad=False)).reshape(
            -1, cfg.vocab_size),
        Tensor(torch.tensor(labels, device=dev), requires_grad=False),
        ignore_index=-100))
    gen = torch.Generator(device=dev).manual_seed(12)
    xd = torch.randn(RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE,
                     generator=gen, device=dev)
    yd = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen, device=dev)
    resnet = (resnet18(), RESNET_LR, lambda m: lg_loss.cross_entropy(
        m(Tensor(xd, requires_grad=False)),
        Tensor(yd.int(), requires_grad=False)))
    counts = {}
    for name, (model, lr, loss_fn) in (("BERT-base", bert),
                                       ("ResNet-18", resnet)):
        mp = amp.MixedPrecision(model, lambda ps: optim.AdamW(ps, lr=lr))
        before = [m.data.clone() for m in mp.masters]
        reset_launch_counts()
        dts, vals = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = loss_fn(model)
            mp.zero_grad()
            mp.scale(loss).backward()
            mp.step()
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
            vals.append(loss.item())
            if len(vals) == 1:
                counts[name] = launch_counts()
                moved = sum(not torch.equal(m.data, b)
                            for m, b in zip(mp.masters, before))
        val = vals[0]
        log(f"  {name} bf16 MixedPrecision AdamW: step 1 loss {val:.4f}, "
            f"{moved} of {len(before)} masters moved, {dts[0] * 1e3:.1f} ms "
            f"(compiles included); step 2 loss {vals[1]:.4f}, "
            f"{dts[1] * 1e3:.1f} ms; {card}")
        if not np.isfinite(val) or moved != len(before):
            raise AssertionError(f"{name} AMP step: loss {val}, {moved} of "
                                 f"{len(before)} masters moved")
        del model, mp, before, loss
        torch.cuda.empty_cache()
    return counts


# --- phase 11: scanned stacks with remat, schedules, checkpoints, LoRA, the
# HF interop and tokenizers ------------------------------------------------
def busy_share(step):
    """One ``step()`` traced by torch.profiler: (device ms of its kernels,
    wall ms of the step)."""
    return traced_families(step)[1:]


def traced_families(step, extra=()):
    """One ``step()`` traced by torch.profiler: ({family: (device ms,
    kernels)} by KERNEL_FAMILIES after ``extra``'s (fragment, family)
    pairs, device ms, wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fams = tuple(extra) + KERNEL_FAMILIES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out = {}
    for e in trace.events():
        if e.device_type == DeviceType.CUDA:
            fam = next((f for k, f in fams if k in e.name), "plain torch")
            ms, n = out.get(fam, (0.0, 0))
            out[fam] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out, sum(ms for ms, _ in out.values()), wall


def traced_kernel_ms(fn):
    """(``fn()``, the device ms of its kernels): CUDA activity alone traced
    by torch.profiler, summed over its raw events (building the profiler's
    event tree for the tens of thousands of launches of a sampling loop or
    an engine run costs seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.duration_ns() for e in
                    trace.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA) / 1e6


def event_steps(step, n):
    """``n`` calls of ``step()``, each between two CUDA events: their ms."""
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in marks:
        start.record()
        step()
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in marks]


def layer_grads(model):
    """{per-layer name: step-1 gradient as f32} of a GPT, its scanned stack
    unstacked."""
    out = {}
    for n, p in model.named_parameters():
        if n.startswith("h.") and p.dim() and "__" in n:
            key = n[2:].replace("__", ".")
            for l in range(p.shape[0]):
                out[f"h.{l}.{key}"] = p.grad[l].float()
        else:
            out[n] = p.grad.float()
    return out


def worst_rel(got, want):
    """max over names of max |got - want| / max |want|, and the name."""
    rel = {n: (got[n] - w).abs().max().item() / max(w.abs().max().item(),
                                                     1e-30)
           for n, w in want.items()}
    name = max(rel, key=rel.get)
    return rel[name], name


def phase_scan_train(card):
    """Phase 11a: GPT-2 small scanned (``scan_layers=True``) at the JAX
    bench's configuration -- vocab 50304, 16 x 1024, bf16
    ``MixedPrecision`` Adam at lr 3e-4 under ``WarmupCosine`` -- with remat
    False, "dots" and "full": step 1's gradients of each against the
    unscanned ModuleList model from the same weights (PATH_TOL bf16) and
    against each other, the losses of every step against each other, then a
    warm-up step and SCAN_TIMED steps timed by CUDA events (tokens/s, peak
    memory, the device's idle share of one profiled step).  First, greedy
    ``generate_device`` of the scanned model (f32) must give the unscanned
    model's tokens.  Returns {path: launch counts}."""
    from lightgrad_tpu_torch import GPT, GPTConfig, amp, optim, schedule
    from lightgrad_tpu_torch.loss import cross_entropy
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, T, V = SCAN_BATCH, SCAN_GPT2["n_positions"], SCAN_GPT2["vocab_size"]
    g = torch.Generator(device=dev).manual_seed(12)
    ids = torch.randint(0, V, (B, T), generator=g, device=dev)
    tgt = torch.randint(0, V, (B * T,), generator=g, device=dev)

    def build(**kw):
        return GPT(GPTConfig(**SCAN_GPT2, **kw), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))

    counts = {}
    ref, sc = build(), build(scan_layers=True, remat="dots")
    sd = ref.state_dict()
    if not all(torch.equal(sc.state_dict()[k], v) for k, v in sd.items()):
        raise AssertionError("the scanned GPT drew other weights")
    prompt = torch.randint(0, V, (64,), generator=g, device=dev).tolist()
    want = ref.generate_device(prompt, SCAN_NEW)
    reset_launch_counts()
    got = sc.generate_device(prompt, SCAN_NEW)
    torch.cuda.synchronize()
    counts["scanned generate_device (f32)"] = launch_counts()
    log(f"  greedy generate_device, {SCAN_NEW} tokens after 64: scanned "
        f"{'==' if got == want else '!='} unscanned")
    if got != want:
        raise AssertionError(f"scanned generate_device {got[64:]} != "
                             f"unscanned {want[64:]}")
    del sc

    def trainer(model):
        mp = amp.MixedPrecision(model, lambda ps: optim.Adam(ps, lr=SCAN_LR),
                                bf16)
        sched = schedule.WarmupCosine(mp.optim, warmup=SCAN_WARMUP,
                                      total=SCAN_WARMUP + 4 + SCAN_TIMED)
        losses = []

        def fwd_bwd():
            loss = cross_entropy(model(ids).reshape(B * T, V), tgt)
            mp.zero_grad()
            loss.backward()
            losses.append(loss.detach())

        def step():
            fwd_bwd()
            mp.step()
            sched.step()
        return fwd_bwd, step, mp, sched, losses

    fwd_bwd, _, _, _, ref_losses = trainer(ref)
    fwd_bwd()
    ref_grads = layer_grads(ref)
    ref_loss = ref_losses[0].item()
    del ref, fwd_bwd
    torch.cuda.empty_cache()
    rates, first = {}, None
    for remat in SCAN_REMATS:
        t0 = time.perf_counter()
        model = build(scan_layers=True, remat=remat)
        model.load_state_dict(sd)
        fwd_bwd, step, mp, sched, losses = trainer(model)
        fwd_bwd()
        grads = layer_grads(model)
        rel, name = worst_rel(grads, ref_grads)
        same = first is not None and all(
            torch.equal(grads[n], first[0][n]) for n in grads)
        log(f"  remat={remat!r}: step-1 loss {losses[0].item():.5f} "
            f"(unscanned {ref_loss:.5f}); gradients vs the unscanned model "
            f"worst rel {rel:.3e} ({name}) tol {PATH_TOL[bf16]:.0e}"
            + ("" if first is None else
               f"; {'bitwise equal to' if same else 'differ from'} "
               f"remat={SCAN_REMATS[0]!r}'s"))
        if rel > PATH_TOL[bf16] or abs(losses[0].item() - ref_loss) > \
                PATH_TOL[bf16] * max(1.0, abs(ref_loss)):
            raise AssertionError(f"scanned GPT-2 remat={remat!r}: step 1 "
                                 f"off the unscanned model ({rel}, {name})")
        if first is None:
            first = (grads, losses)
        del grads
        mp.step()
        sched.step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times = event_steps(step, 1 + SCAN_TIMED)
        counts[f"scanned GPT-2 training (remat={remat!r})"] = \
            launch_counts()
        peak = torch.cuda.max_memory_allocated()
        busy, wall = busy_share(step)
        vals = [v.item() for v in losses]
        tok_s = B * T / (float(np.median(times[1:])) / 1e3)
        rates[remat] = (tok_s, peak, 1 - busy / wall)
        log(f"  remat={remat!r}: losses {[round(v, 4) for v in vals]}; "
            f"{B}x{T} tokens a step: {tok_s:.1f} tok/s (median of "
            f"{SCAN_TIMED} steps after a warm-up, step ms "
            f"{[round(t, 2) for t in times]}); peak memory "
            f"{peak / 2**30:.2f} GiB; profiled step: device {busy:.1f} of "
            f"{wall:.1f} ms (idle {100 * (1 - busy / wall):.1f}%); "
            f"lr now {mp.optim.lr.item():.3e}; {card}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not (np.all(np.isfinite(vals)) and vals[-1] < vals[0]):
            raise AssertionError(f"remat={remat!r}: loss not finite and "
                                 f"falling: {vals}")
        drift = max(abs(a - b) / max(1.0, abs(b))
                    for a, b in zip(vals, [v.item() for v in first[1]]))
        if drift > PATH_TOL[bf16]:
            raise AssertionError(f"remat={remat!r}: losses drift {drift} "
                                 f"from remat={SCAN_REMATS[0]!r}'s")
        del model, mp, sched, step, fwd_bwd, losses
        torch.cuda.empty_cache()
    log("  scanned GPT-2 small, bf16 MixedPrecision Adam, 16 x 1024: "
        + "; ".join(f"remat={r!r} {t:.1f} tok/s, peak {p / 2**30:.2f} GiB, "
                    f"idle {100 * i:.1f}%" for r, (t, p, i) in rates.items())
        + f"; {card}")
    del ref_grads, first
    torch.cuda.empty_cache()
    return counts


def resume_check(name, build, step, n=3):
    """``n`` steps straight against ``n - 1``, ``save_checkpoint``, fresh
    objects, ``load_checkpoint``, one step: the last loss and every
    parameter bit for bit (one host read).  Returns the save and load
    seconds and the file's bytes."""
    import tempfile

    from lightgrad_tpu_torch import checkpoint

    m1, o1 = build()
    straight = [step(m1, o1) for _ in range(n)]
    m2, o2 = build()
    for _ in range(n - 1):
        step(m2, o2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resume.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(path, m2, o2, step=n - 1)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        del m2, o2
        m3, o3 = build()
        t0 = time.perf_counter()
        meta = checkpoint.load_checkpoint(path, m3, o3)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    resumed = step(m3, o3)

    def datas(m):
        return [p.data if not isinstance(p, torch.Tensor) else p.detach()
                for p in m.parameters()]

    diff = torch.stack([(a != b).any() for a, b in zip(datas(m1), datas(m3))]
                       + [(resumed != straight[-1]).any()]).any().item()
    log(f"  {name}: step {n} resumed from a checkpoint of step "
        f"{int(meta['step'])} (save {t_save:.1f} s, load {t_load:.1f} s, "
        f"{size / 2**20:.1f} MiB): loss {resumed.item():.6f}, uninterrupted "
        f"{straight[-1].item():.6f}; loss and every parameter "
        f"{'bitwise equal' if not diff else 'DIFFER'}")
    if diff:
        raise AssertionError(f"{name}: the resumed run is not the "
                             f"uninterrupted one bit for bit")


def phase_checkpoint(card):
    """Phase 11b: bitwise resume.  GPT-2 small, f32 Adam on CKPT_BATCH x
    1024 tokens; BERT-base on the tape, its encoder a ``ScannedStack`` with
    remat "dots" (the tape's scanned path on the card; per-layer names in
    the file), f32 AdamW on the BERT phase's masked batch.  Returns {path:
    launch counts}."""
    from lightgrad_tpu_torch import GPT, GPTConfig, optim
    from lightgrad_tpu_torch import loss as lg_loss, random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.loss import cross_entropy
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    counts = {}
    V, T = GPT2_SMALL["vocab_size"], GPT2_SMALL["n_positions"]
    g = torch.Generator(device=dev).manual_seed(13)
    ids = torch.randint(0, V, (CKPT_BATCH, T), generator=g, device=dev)
    tgt = torch.randint(0, V, (CKPT_BATCH * T,), generator=g, device=dev)

    def gpt():
        m = GPT(GPTConfig(**GPT2_SMALL), device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
        return m, optim.Adam(m.parameters(), lr=TRAIN_LR)

    def gpt_step(m, o):
        loss = cross_entropy(m(ids).reshape(-1, V), tgt)
        o.zero_grad()
        loss.backward()
        o.step()
        return loss.detach()

    reset_launch_counts()
    resume_check(f"GPT-2 small, f32 Adam, {CKPT_BATCH} x {T}", gpt,
                 gpt_step)
    counts["GPT-2 small resume"] = launch_counts()
    torch.cuda.empty_cache()

    cfg = BertConfig(**BERT_BASE, scan_layers=True, remat="dots")
    b_ids, mask, labels, _ = bert_batch(cfg)
    x_ids = Tensor.from_numpy(b_ids, requires_grad=False)
    x_mask = Tensor.from_numpy(mask, requires_grad=False)
    y = Tensor.from_numpy(labels, requires_grad=False)

    def bert():
        lg_random.seed(0)
        m = BertForMaskedLM(cfg)
        return m, optim.AdamW(list(m.parameters()), lr=BERT_LR)

    def bert_step(m, o):
        logits = m(x_ids, attention_mask=x_mask)
        loss = lg_loss.cross_entropy(logits.reshape(-1, cfg.vocab_size), y,
                                     ignore_index=-100)
        o.zero_grad()
        loss.backward()
        o.step()
        return loss.data.detach()

    reset_launch_counts()
    resume_check(f"BERT-base on the tape (scanned, remat 'dots'), f32 "
                 f"AdamW, {BERT_BATCH} x {BERT_SEQ}", bert, bert_step)
    counts["BERT-base resume"] = launch_counts()
    torch.cuda.empty_cache()
    return counts


def phase_lora(card):
    """Phase 11c: LoRA at Mistral-7B's widths (d 4096, 32 heads, 8 KV heads,
    ff 14336, vocab 32000, window 4096) cut to the LLaMA training phase's 2
    layers, in bf16: rank-8 adapters on q_proj and v_proj (f32), LORA_STEPS
    AdamW steps on ``lora_parameters`` under ``WarmupCosine`` on one batch
    of 1 x 8192 tokens.  The loss must fall, only the adapters may change
    (one host read), and after ``merge_lora`` the forward equals the
    adapted forward at bf16 tolerance.  Returns the steps' launch
    counts."""
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import lora, optim, schedule
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    model = llama_model(MISTRAL_7B, bf16, num_hidden_layers=2)
    S, V = LORA_SEQ, MISTRAL_7B["vocab_size"]
    dev = torch.device("cuda")
    wrapped = lora.apply_lora(model, rank=LORA_RANK,
                              targets=("q_proj", "v_proj"),
                              generator=torch.Generator(device=dev)
                              .manual_seed(0))
    params = lora.lora_parameters(model)
    frozen = [(p, p.data.clone()) for n, p in model.named_parameters()
              if "lora_" not in n]
    n_ad = sum(p.numel() for p in params)
    log(f"  adapters on {len(wrapped)} Linears: {n_ad} parameters (f32) "
        f"over {sum(p.numel() for p, _ in frozen) / 1e9:.3f} B frozen "
        f"bf16 ones")
    opt = optim.AdamW(params, lr=LORA_LR)
    sched = schedule.WarmupCosine(opt, warmup=2, total=LORA_STEPS + 2)
    ids = np.random.default_rng(14).integers(0, V, (1, S + 1)) \
        .astype(np.int32)
    x = Tensor.from_numpy(ids[:, :-1], requires_grad=False)
    y = Tensor.from_numpy(ids[:, 1:].reshape(-1), requires_grad=False)
    losses = []

    def step():
        logits = model(x)
        loss = lg_loss.cross_entropy(
            logits.reshape(S, V).astype(torch.float32), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        sched.step()
        losses.append(loss.data.detach())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = event_steps(step, LORA_STEPS)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    vals = [v.item() for v in losses]
    changed = torch.stack([(p.data != v).any() for p, v in frozen]
                          + [~torch.stack([p.data.any() for n, p in
                                           model.named_parameters()
                                           if n.endswith("lora_B")]).all()])
    bad = changed.any().item()
    step_ms = float(np.median(times[1:]))
    log(f"  losses {[round(v, 4) for v in vals]}; step ms "
        f"{[round(t, 2) for t in times]} (median of steps 2-{LORA_STEPS} "
        f"{step_ms:.2f} ms, {S / step_ms * 1e3:.1f} tok/s); peak memory "
        f"{peak / 2**30:.2f} GiB; frozen parameters "
        + ("unchanged, every B moved" if not bad else
           "CHANGED or a B still zero") + f"; {card}")
    if bad or not (np.all(np.isfinite(vals)) and vals[-1] < vals[0]):
        raise AssertionError(f"LoRA: losses {vals}, frozen changed or a B "
                             f"still zero: {bad}")
    del frozen
    from lightgrad_tpu_torch import no_grad

    with no_grad():
        adapted = model(x).data
        merged = lora.merge_lora(model)
        plain = model(x).data
    check(f"LoRA forward after merge_lora ({len(merged)} layers) vs the "
          f"adapted forward", bf16, plain, adapted, PATH_TOL[bf16])
    log(f"  LoRA phase: {time.perf_counter() - t0:.1f} s")
    del model, opt, adapted, plain
    torch.cuda.empty_cache()
    return counts


def learn_bpe(text, n_merges):
    """A byte-level vocabulary (the 256 byte symbols, then each merge's
    result) and merges learned from ``text`` (the most frequent adjacent
    pair of the pre-split words merged ``n_merges`` times)."""
    import collections

    from lightgrad_tpu_torch.models import GPT2Tokenizer

    enc = GPT2Tokenizer._bytes_to_unicode()
    words = collections.Counter(
        tuple(enc[b] for b in w.encode("utf-8"))
        for w in GPT2Tokenizer._PAT.findall(text))
    vocab = {enc[b]: i for i, b in enumerate(sorted(enc))}
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        vocab.setdefault(best[0] + best[1], len(vocab))
        new = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] += c
        words = new
    return vocab, merges


def phase_serving_io(card):
    """Phase 11d: serving I/O.  ``GPT2Tokenizer`` over a vocabulary and
    merges learned from this script's docstring; ``encode`` -> bf16 GPT-2
    small ``generate_device`` -> ``decode``.  ``save_pretrained`` ->
    ``from_pretrained`` through a temporary ``LIGHTGRAD_CACHE`` (files named
    md5(url)): identical logits.  ``BertTokenizer.synthetic()`` -> a
    BERT-base masked-LM forward.  Returns {path: launch counts}."""
    import hashlib
    import tempfile

    from lightgrad_tpu_torch import GPT, GPTConfig, no_grad
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models import BertTokenizer, GPT2Tokenizer
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    counts = {}
    t0 = time.perf_counter()
    vocab, merges = learn_bpe(__doc__, IO_MERGES)
    tok = GPT2Tokenizer(vocab, merges)
    text = ("The conv path on the tape: ResNet-18 at its torchvision "
            "widths, the loss must be finite and fall.")
    ids = tok.encode(text)
    if tok.decode(ids) != text:
        raise AssertionError("GPT2Tokenizer: decode(encode(text)) != text")
    log(f"  GPT2Tokenizer: {len(vocab)} entries, {len(merges)} merges "
        f"learned in {time.perf_counter() - t0:.2f} s; {len(text)} "
        f"characters -> {len(ids)} ids, decode(encode) == text")
    model = GPT(GPTConfig(**GPT2_SMALL), device=dev,
                generator=torch.Generator(device=dev).manual_seed(0)) \
        .to(bf16)
    reset_launch_counts()
    out = model.generate_device(ids, IO_NEW)
    torch.cuda.synchronize()
    counts["GPT2Tokenizer -> generate_device (bf16)"] = launch_counts()
    reply = tok.decode(out[len(ids):])
    log(f"  generate_device: {IO_NEW} tokens after {len(ids)}; "
        f"{sum(i < len(vocab) for i in out[len(ids):])} of them in the "
        f"tokenizer's vocabulary, decoded to {reply!r}")
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        path = model.save_pretrained(os.path.join(tmp, "saved"))
        url = "https://huggingface.co/smoke/gpt2/resolve/main/"
        cache = os.path.join(tmp, "cache")
        os.makedirs(cache)
        for name in ("pytorch_model.bin", "config.json"):
            key = hashlib.md5((url + name).encode()).hexdigest()
            with open(os.path.join(os.path.dirname(path), name), "rb") as f, \
                    open(os.path.join(cache, key), "wb") as out:
                out.write(f.read())
        prev = os.environ.get("LIGHTGRAD_CACHE")
        os.environ["LIGHTGRAD_CACHE"] = cache
        try:
            back, _ = GPT.from_pretrained("smoke/gpt2", device=dev,
                                          dtype=bf16)
        finally:
            if prev is None:
                del os.environ["LIGHTGRAD_CACHE"]
            else:
                os.environ["LIGHTGRAD_CACHE"] = prev
        size = os.path.getsize(path)
        t_io = time.perf_counter() - t1
    x = torch.tensor([ids], device=dev)
    with torch.no_grad():
        same = torch.equal(model(x), back(x))
    log(f"  save_pretrained -> from_pretrained through LIGHTGRAD_CACHE "
        f"({size / 2**20:.1f} MiB, {t_io:.1f} s): logits "
        f"{'identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("from_pretrained(save_pretrained) logits differ")
    del model, back
    torch.cuda.empty_cache()

    btok = BertTokenizer.synthetic()
    btext = "tok1 tok22 [MASK] tok994 tok7 , tok3 [mask] tok5"
    bids = btok.encode(btext)
    lg_random.seed(0)
    bert = BertForMaskedLM(BertConfig(**BERT_BASE))
    reset_launch_counts()
    with no_grad():
        logits = bert(Tensor.from_numpy(np.array([bids], np.int32),
                                        requires_grad=False)).data
    torch.cuda.synchronize()
    counts["BertTokenizer -> BERT-base masked LM"] = launch_counts()
    at = [i for i, t in enumerate(bids) if t == btok.ids["[MASK]"]]
    top = logits[0, at, :len(btok.vocab)].argmax(-1).tolist()
    if not torch.isfinite(logits).all() or len(at) != 2:
        raise AssertionError("BERT masked-LM forward: not finite, or the "
                             "masks were not found")
    log(f"  BertTokenizer.synthetic(): {btext!r} -> {len(bids)} ids, "
        f"[MASK] at {at}; BERT-base's top tokens there "
        f"{btok.convert_ids_to_tokens(top)}; serving I/O "
        f"{time.perf_counter() - t0:.1f} s")
    del bert, logits
    torch.cuda.empty_cache()
    return counts


# --- phase 12: the vision families and the oracle ---------------------------
def plain_vit(p, cfg, x):
    """ViTForImageClassification's logits through the plain PyTorch versions
    of the kernels (``_reference``), differentiable by torch autograd: the
    twin the tape's step must meet.  ``p``: parameters by name."""
    from lightgrad_tpu_torch.ops.elementwise import ew_reference
    from lightgrad_tpu_torch.ops.layernorm import layernorm_fwd_reference
    from lightgrad_tpu_torch.ops.matmul import matmul_reference

    B, d, H = x.shape[0], cfg.hidden_size, cfg.num_attention_heads
    hd, S = d // H, cfg.num_patches + 1

    def ln(t, pre):
        return layernorm_fwd_reference(t, p[pre + ".weight"],
                                       p[pre + ".bias"],
                                       cfg.layer_norm_eps)[0]

    def lin(t, pre):
        return matmul_reference(t, p[pre + ".weight"].T) + p[pre + ".bias"]

    def heads(t):
        return t.reshape(B, S, H, hd).transpose(1, 2)

    e = "vit.embeddings."
    y = _PlainConv.apply(x, p[e + "projection.w"], cfg.patch_size) \
        + p[e + "projection.b"]
    y = y.reshape(B, d, S - 1).transpose(1, 2)
    y = torch.cat([p[e + "cls_token"].expand(B, 1, d), y], 1) \
        + p[e + "position_embeddings"]
    for layer in range(cfg.num_hidden_layers):
        pre = f"vit.layer.{layer}."
        h = ln(y, pre + "layernorm_before")
        q, k, v = (heads(lin(h, pre + "attention." + n))
                   for n in ("query", "key", "value"))
        a = _PlainAttention.apply(q, k, v, hd ** -0.5, 0, False)
        y = y + lin(a.transpose(1, 2).reshape(B, S, d), pre + "attn_output")
        h = ew_reference("f_gelu", lin(ln(y, pre + "layernorm_after"),
                                       pre + "intermediate"))
        y = y + lin(h, pre + "output")
    return lin(ln(y, "vit.layernorm")[:, 0], "classifier")


def vit_kernel_checks(cfg, B):
    """The ViT path's own shapes on the card: the patch embedding's conv
    (B x 3 x 224² by 768 x 3 x 16², stride 16) on its route, forward, dx
    and dw, against the plain versions at KERNEL_TOL; the flash forward and
    the two backward passes at (B x 12 heads, S 197, d 64), unmasked and
    non-causal -- three 64-row tiles and 5 rows -- against the plain
    forward and the backward evaluated in f64, in f32 and bf16; an output
    whose last 5 rows are zero must fail each check."""
    from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                                   attention_fwd_reference,
                                                   attention_fwd_res)
    from lightgrad_tpu_torch.ops.conv import (
        conv_bwd_dw, conv_bwd_dw_reference, conv_bwd_dx,
        conv_bwd_dx_reference, conv_fwd, conv_fwd_reference, conv_route)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    P, d, C = cfg.patch_size, cfg.hidden_size, cfg.num_channels
    n = cfg.image_size // P
    S, hd = n * n + 1, d // cfg.num_attention_heads
    for dtype in (torch.float32, torch.bfloat16):
        tol = KERNEL_TOL[dtype]
        x = torch.randn(B, C, cfg.image_size, cfg.image_size, generator=g,
                        device=dev).to(dtype)
        w = (torch.randn(d, C, P, P, generator=g, device=dev)
             * (C * P * P) ** -0.5).to(dtype)
        dy = torch.randn(B, d, n, n, generator=g, device=dev).to(dtype)
        route = conv_route(x.shape, w.shape, 1, dtype)
        tag = f"ViT patch conv {tuple(x.shape)} * {tuple(w.shape)} /{P} " \
              f"(route {route})"
        for what, got, want in (
                ("fwd", conv_fwd(x, w, P), conv_fwd_reference(x, w, P)),
                ("dx", conv_bwd_dx(dy, w, x.shape, P),
                 conv_bwd_dx_reference(dy, w, x.shape, P)),
                ("dw", conv_bwd_dw(dy, x, w.shape, P),
                 conv_bwd_dw_reference(dy, x, w.shape, P))):
            check(f"{tag} {what}", dtype, got, want, tol)
            discriminates(f"{tag} {what}", dtype, want, tol,
                          torch.zeros_like(want))
        del x, w, dy
        bh = B * cfg.num_attention_heads
        q, k, v, do = (torch.randn(bh, S, hd, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        sc = hd ** -0.5
        tag = f"ViT attention ({bh}, {S}, {hd}) unmasked"
        out, lse = attention_fwd_res(q, k, v, sc)
        ref = attention_fwd_reference(q, k, v, sc)[0]
        cut = ref.clone()
        cut[:, -(S % 64):] = 0
        check_fwd(f"{tag} fwd", dtype, out, ref, torch.zeros_like(ref), cut)
        got = attention_bwd(do, q, k, v, sc, out=out, lse=lse)
        want, allow = bwd_reference(dtype, do, q, k, v, out, lse, sc, False)
        for name, a, wv, al in zip(("dq", "dk", "dv"), got, want, allow):
            cut = wv.clone()
            cut[:, -(S % 64):] = 0
            check_bwd(f"{tag} {name}", dtype, a, wv, tol, cut,
                      allow=al)
        del q, k, v, do, out, lse, ref, got, want, allow
        torch.cuda.empty_cache()


def phase_vit(card):
    """Phase 12a: ViT-B/16 at ``google/vit-base-patch16-224``'s widths
    (``ViTConfig``'s defaults: 224², patch 16, width 768, 12 layers, 12
    heads, FFN 3072, 1000 labels; seeded random weights) on the tape,
    after :func:`vit_kernel_checks`: float32 AdamW, VIT_STEPS steps on one
    batch of VIT_BATCH random images and labels (197 tokens an image) --
    step 1's logits and every gradient against the plain twin (PATH_TOL),
    and the ``scan_layers=True`` model with remat "full" on the same
    weights, whose step-1 gradients must equal the unscanned model's bit
    for bit; the loss must fall; images/s, peak memory, where a step's time
    goes; eval logits against the plain forward; then one bf16
    ``MixedPrecision`` AdamW step and the bf16 eval logits against the
    plain bf16 forward.  Returns {path: launch counts}."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch import amp, no_grad, optim, random as lg_random
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models import (ViTConfig,
                                            ViTForImageClassification)
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg, B, f32 = ViTConfig(**VIT_CFG), VIT_BATCH, torch.float32
    t0 = time.perf_counter()
    vit_kernel_checks(cfg, B)
    log(f"  ViT kernel checks: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    lg_random.seed(0)
    model = ViTForImageClassification(cfg)
    n_params = sum(int(np.prod(t.shape)) for t in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(13)
    xd = torch.randn(B, cfg.num_channels, cfg.image_size, cfg.image_size,
                     generator=gen, device=dev)
    yd = torch.randint(0, cfg.num_labels, (B,), generator=gen, device=dev)
    x, y = Tensor(xd, requires_grad=False), Tensor(yd.int(),
                                                    requires_grad=False)
    log(f"  {n_params / 1e6:.2f} M parameters, {B} x 3 x {cfg.image_size}² "
        f"images, {B * (cfg.num_patches + 1)} tokens a step")

    def twin(params, dtype):
        ps = {n: t.data.detach().to(dtype).requires_grad_(True)
              for n, t in params}
        logits = plain_vit(ps, cfg, xd.to(dtype))
        loss = F.cross_entropy(logits.float(), yd)
        return logits.detach(), loss.item(), dict(zip(ps, torch.autograd.grad(
            loss, list(ps.values()))))

    def step_fn(m, o):
        loss = lg_loss.cross_entropy(m(x), y)
        o.zero_grad()
        loss.backward()
        o.step()

    # the scan_layers=True model, remat "full", from the same weights: its
    # step-1 gradients by per-layer name, for the unscanned step to meet
    sc = ViTForImageClassification(ViTConfig(**VIT_CFG, scan_layers=True,
                                              remat="full"))
    sc.load_parameters(dict(model.named_parameters()))
    counts = {}
    reset_launch_counts()
    sc_loss = lg_loss.cross_entropy(sc(x), y)
    sc_loss.backward()
    torch.cuda.synchronize()
    counts["ViT-B/16 scanned, remat 'full'"] = launch_counts()
    sc_grads = {}
    for n, t in sc.named_parameters():
        if "__" in n:
            key = n.split("vit.layer.", 1)[1].replace("__", ".")
            for layer in range(cfg.num_hidden_layers):
                sc_grads[f"vit.layer.{layer}.{key}"] = t.grad.data[layer]
        else:
            sc_grads[n] = t.grad.data
    sc_loss = sc_loss.item()
    del sc
    torch.cuda.empty_cache()

    def scanned_check():
        diff = [n for n, t in model.named_parameters()
                if not torch.equal(t.grad.data, sc_grads[n])]
        rel, name = worst_rel({n: t.grad.data for n, t in
                               model.named_parameters()}, sc_grads)
        log(f"  scan_layers=True, remat 'full': step-1 loss {sc_loss:.6f}; "
            f"{len(sc_grads) - len(diff)} of {len(sc_grads)} gradients bit "
            f"for bit the unscanned model's (worst rel {rel:.3e}, {name})")
        if diff:
            raise AssertionError(f"scanned ViT: gradients differ from the "
                                 f"unscanned model's: {diff[:5]}")

    opt = optim.AdamW(list(model.parameters()), lr=VIT_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, host = [], [], []
    for step in range(VIT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(x)
        loss = lg_loss.cross_entropy(logits, y)
        opt.zero_grad()
        loss.backward()
        host.append(time.perf_counter() - t0)   # forward + backward queued
        if step == 0:               # the checks' time is not the step's
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            plain_logits, plain_loss, grads32 = twin(
                model.named_parameters(), f32)
            check("ViT-B/16 logits vs the plain twin", f32, logits.data,
                  plain_logits, PATH_TOL[f32])
            log(f"  step-1 loss {loss.item():.5f}, plain twin "
                f"{plain_loss:.5f}")
            tape_grad_check(model, grads32)
            scanned_check()
            del grads32, plain_logits, sc_grads
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 += time.perf_counter() - c0
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        del logits, loss
    counts["ViT-B/16 training"] = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    img_s = B / float(np.median(times[1:]))
    log(f"  losses: {[round(v, 4) for v in losses]} "
        f"({'finite, falling' if ok else 'FAIL'})")
    log(f"  {B} images a step: {img_s:.1f} images/s (median of steps "
        f"2-{VIT_STEPS}, step times {[round(t, 4) for t in times]} s); "
        f"peak memory of steps 2-{VIT_STEPS} {peak / 2**30:.2f} GiB; {card}")
    per_step = {k: v // VIT_STEPS
                for k, v in counts["ViT-B/16 training"].items() if v}
    log(f"  launches per step: {per_step}")
    if not ok:
        raise AssertionError(f"ViT-B/16 loss not finite and falling: "
                             f"{losses}")
    step_breakdown(lambda: step_fn(model, opt), float(np.median(times[1:])),
                   float(np.median(host[1:])))

    def eval_check(dtype):
        model.eval()
        with no_grad():
            got = model(x).data
        with torch.no_grad():
            want = plain_vit({n: t.data for n, t in model.named_parameters()},
                             cfg, xd.to(dtype))
        model.train()
        check("ViT-B/16 eval logits vs the plain forward", dtype, got,
              want, PATH_TOL[dtype])

    eval_check(f32)
    del opt
    torch.cuda.empty_cache()
    mp = amp.MixedPrecision(model, lambda ps: optim.AdamW(ps, lr=VIT_LR))
    before = [m.data.clone() for m in mp.masters]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = lg_loss.cross_entropy(model(x), y)
    mp.zero_grad()
    mp.scale(loss).backward()
    mp.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts["ViT-B/16 bf16 MixedPrecision step"] = launch_counts()
    moved = sum(not torch.equal(m.data, b) for m, b in zip(mp.masters,
                                                           before))
    log(f"  bf16 MixedPrecision AdamW step: loss {loss.item():.4f}, {moved} "
        f"of {len(before)} masters moved, {dt * 1e3:.1f} ms (compiles "
        f"included); {card}")
    if not np.isfinite(loss.item()) or moved != len(before):
        raise AssertionError(f"ViT-B/16 AMP step: loss {loss.item()}, "
                             f"{moved} of {len(before)} masters moved")
    del before, loss
    eval_check(torch.bfloat16)
    del model, mp, x, y
    torch.cuda.empty_cache()
    return counts


def plain_unet(p, unet, x, tf):
    """The UNet's noise prediction through the plain PyTorch versions of the
    kernels, in the tape's formulas -- GroupNorm's mean and variance,
    ``ConvTranspose2d`` as a stride-1 conv over the zero-dilated input and
    the flipped kernel -- differentiable by torch autograd.  ``p``: the
    parameters by name; ``unet`` gives the layout; ``tf`` the float
    timesteps (b,)."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.ops.elementwise import ew_reference
    from lightgrad_tpu_torch.ops.matmul import matmul_reference

    def lin(h, pre):
        return matmul_reference(h, p[pre + ".weight"].T) + p[pre + ".bias"]

    def conv(h, pre, layer):
        lo, hi = layer.p if isinstance(layer.p, tuple) else (layer.p,) * 2
        y = _PlainConv.apply(F.pad(h, (lo, hi, lo, hi)), p[pre + ".w"],
                             layer.s)
        return y if layer.b is None else y + p[pre + ".b"]

    def conv_t(h, pre, layer):
        w, s = p[pre + ".w"], layer.s
        b, c, hh, ww = h.shape
        z = h.new_zeros(b, c, (hh - 1) * s + 1, (ww - 1) * s + 1)
        z[:, :, ::s, ::s] = h
        lo = w.shape[-1] - 1 - layer.p
        z = F.pad(z, (lo, lo + layer.op, lo, lo + layer.op))
        wf = w.flip(-1, -2).transpose(0, 1).contiguous()
        return _PlainConv.apply(z, wf, 1) + p[pre + ".b"]

    def gn(h, pre, m):
        c = h.shape[1]
        hs = h.reshape(h.shape[0], m.groups, -1)
        d = hs - hs.mean(-1, keepdim=True)
        var = (d * d).mean(-1, keepdim=True)
        hn = (d * (var + m.eps) ** -0.5).reshape(h.shape)
        return hn * p[pre + ".weight"].reshape(1, c, 1, 1) \
            + p[pre + ".bias"].reshape(1, c, 1, 1)

    def silu(h):
        return h * torch.sigmoid(h)

    def block(h, emb, pre):
        m = getattr(unet, pre)
        y = conv(silu(gn(h, pre + ".norm1", m.norm1)), pre + ".conv1",
                 m.conv1)
        y = y + lin(silu(emb), pre + ".temb").reshape(h.shape[0], -1, 1, 1)
        y = conv(silu(gn(y, pre + ".norm2", m.norm2)), pre + ".conv2",
                 m.conv2)
        return y + (h if m.skip is None else conv(h, pre + ".skip", m.skip))

    half = unet.time_dim // 2
    freqs = torch.tensor(np.exp(-np.log(10000.0) * np.arange(
        half, dtype=np.float32) / half), device=x.device)
    ang = tf.reshape(-1, 1) * freqs.reshape(1, half)
    emb = torch.cat([ang.sin(), ang.cos()], -1)
    emb = lin(ew_reference("f_gelu", lin(emb, "time_mlp.0")), "time_mlp.2")
    h1 = block(conv(x, "stem", unet.stem), emb, "rb_d1")
    h2 = block(conv(h1, "down1", unet.down1), emb, "rb_d2")
    mid = block(conv(h2, "down2", unet.down2), emb, "rb_mid")
    u2 = block(torch.cat([conv_t(mid, "up2", unet.up2), h2], 1), emb,
               "rb_u2")
    u1 = block(torch.cat([conv_t(u2, "up1", unet.up1), h1], 1), emb,
               "rb_u1")
    return conv(silu(gn(u1, "out_norm", unet.out_norm)), "out", unet.out)


# the oracle phase's sweep: name -> (tape function, input shapes, flag)
ORACLE_OPS = {
    "exp": (lambda a: a.exp(), [(64, 96)], ""),
    "log": (lambda a: a.log(), [(64, 96)], "positive"),
    "tanh": (lambda a: a.tanh(), [(64, 96)], ""),
    "sigmoid": (lambda a: a.sigmoid(), [(64, 96)], ""),
    "gelu": (lambda a: a.gelu(), [(64, 96)], ""),
    "sin": (lambda a: a.sin(), [(64, 96)], ""),
    "add (row broadcast)": (lambda a, b: a + b, [(64, 96), (96,)], ""),
    "sub (column broadcast)": (lambda a, b: a - b, [(64, 96), (64, 1)], ""),
    "mul (batch broadcast)": (lambda a, b: a * b,
                              [(8, 64, 96), (8, 1, 96)], ""),
    "div": (lambda a, b: a / b, [(64, 96), (64, 96)], "positive"),
    "pow": (lambda a, b: a ** b, [(64, 96), (96,)], "positive"),
    "dot": (lambda a, b: a @ b, [(64, 96), (96, 80)], ""),
    "dot (batched)": (lambda a, b: a @ b, [(4, 64, 96), (4, 96, 32)], ""),
    "sum": (lambda a: a.sum(axis=1), [(64, 96)], ""),
    "sum (all)": (lambda a: a.sum(), [(64, 96)], ""),
    "max": (lambda a: a.max(axis=-1), [(64, 96)], ""),
    "mean": (lambda a: a.mean(axis=0), [(64, 96)], ""),
    "softmax": (lambda a: a.softmax(axis=-1), [(64, 96)], ""),
    "conv (tensor cores)": (lambda x, w: x.conv(w),
                            [(4, 16, 12, 12), (32, 16, 3, 3)], ""),
    "conv (CUDA cores, stride 2)": (lambda x, w: x.conv(w, strides=2),
                                    [(4, 3, 13, 13), (8, 3, 3, 3)], ""),
    "max_pool2d": (lambda a: a.max_pool2d(kernel=3, stride=2, padding=1),
                   [(2, 8, 12, 12)], ""),
    "mean_pool": (lambda a: a.mean_pool(kernel=(2, 2)), [(2, 8, 12, 12)],
                  ""),
    "getitem (slices)": (lambda a: a[1:, 2:50], [(64, 96)], ""),
    "getitem (gather)": (lambda a: a[np.array([0, 5, 5, 2])], [(64, 96)],
                         ""),
    "concat": (lambda a, b: a.concat(b, axis=0), [(16, 32), (8, 32)], ""),
}
# assert_gradcheck on the card: name -> (function of the input and a fixed
# tensor of the second shape, the input's shape, the second shape)
GRADCHECK_OPS = {
    "tanh": (lambda a, c: a.tanh(), (3, 4), None),
    "sum": (lambda a, c: a.sum(axis=1), (3, 4), None),
    "mul (broadcast)": (lambda a, c: a * c, (3, 4), (1, 4)),
    "softmax": (lambda a, c: a.softmax(axis=-1), (3, 5), None),
    "dot": (lambda a, c: a @ c, (3, 4), (4, 2)),
    "conv (input)": (lambda a, c: a.conv(c), (1, 2, 5, 5), (3, 2, 3, 3)),
    "conv (weight)": (lambda a, c: c.conv(a), (3, 2, 3, 3), (1, 2, 5, 5)),
}


def phase_oracle(card):
    """Phase 12c: the reference's "compare with cpu" pattern on the card.
    Each op of ORACLE_OPS on ``CudaTensor``s on the card (float32) against
    the numpy ``CpuTensor`` on the same numpy inputs -- the oracle's inputs
    made by ``.cpu()`` from the card's tensors -- forward and every input's
    gradient of a weighted sum, within the oracle checkers' 1e-3 (rtol and
    atol); then ``assert_gradcheck`` (5e-4) on the ops of GRADCHECK_OPS on
    the card.  Returns {path: launch counts}."""
    from lightgrad_tpu_torch.autograd import CpuTensor, CudaTensor
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightgrad_tpu_torch.utils.gradcheck import assert_gradcheck

    rng = np.random.default_rng(16)

    def run(fn, ts):
        y = fn(*ts)
        w = np.random.default_rng(17).standard_normal(y.shape)
        (y * type(y).from_numpy(w, requires_grad=False)).sum().backward()
        return [y.numpy()] + [t.grad.numpy() for t in ts]

    reset_launch_counts()
    worst = (0.0, "")
    for name, (fn, shapes, flag) in ORACLE_OPS.items():
        arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        if flag == "positive":
            arrays = [np.abs(a) + 0.5 for a in arrays]
        card_ts = [CudaTensor.from_numpy(a) for a in arrays]
        oracle_ts = [t.cpu() for t in card_ts]
        if not all(type(t) is CpuTensor for t in oracle_ts):
            raise AssertionError(".cpu() of a CudaTensor is not a CpuTensor")
        got, want = run(fn, card_ts), run(fn, oracle_ts)
        for what, a, b in zip(["forward"] + [f"d{i}" for i in
                                             range(len(arrays))], got, want):
            # the share of the checkers' bar, |err| <= 1e-3 + 1e-3 |ref|
            share = float(np.max(np.abs(a - b) / (1e-3 + 1e-3 * np.abs(b))))
            worst = max(worst, (share, f"{name} {what}"))
            if not share <= 1.0:
                raise AssertionError(f"oracle: {name} {what} off the numpy "
                                     f"CpuTensor ({share:.3f} of the bar)")
    torch.cuda.synchronize()
    counts = {"oracle sweep": launch_counts()}
    log(f"  {len(ORACLE_OPS)} ops, forward and gradients, CudaTensor on the "
        f"card vs the numpy CpuTensor: all within rtol = atol = 1e-3 (worst "
        f"{worst[0]:.3f} of the bar, {worst[1]})")
    reset_launch_counts()
    for name, (fn, shape, other) in GRADCHECK_OPS.items():
        x = CudaTensor.from_numpy(rng.uniform(-1, 1, shape).astype(
            np.float32))
        c = None if other is None else CudaTensor.from_numpy(
            rng.uniform(-1, 1, other).astype(np.float32), requires_grad=False)
        assert_gradcheck(lambda t: fn(t, c), x)
    torch.cuda.synchronize()
    counts["gradcheck"] = launch_counts()
    log(f"  assert_gradcheck on the card (atol = rtol = 5e-4): "
        f"{', '.join(GRADCHECK_OPS)} ok; {card}")
    return counts


def t5_model(cfg_dict):
    """A T5ForConditionalGeneration of ``cfg_dict`` on the card, random
    weights from the tape's generator at seed 0; the shared table redrawn
    N(0, 1), as HF initialises it (the package's xavier bound at 32128 x
    768, 2e-4, leaves a tied head's logits near 1e-4 and the loss at
    ln V whatever the model computes)."""
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.models import (T5Config,
                                            T5ForConditionalGeneration)

    lg_random.seed(0)
    model = T5ForConditionalGeneration(T5Config(**cfg_dict))
    w = model.shared.weight.data
    w.copy_(torch.randn(w.shape, device=w.device, generator=torch.Generator(
        device=w.device).manual_seed(27)))
    return model


def t5_batch(vocab):
    """T5_BATCH sources of T5_SRC tokens, rows 1 and 5 padded to
    T5_PADDED's lengths (pad id 0, mask 0 past them), and T5_BATCH x T5_TGT
    labels; ids from 2 up (0 is pad, 1 eos)."""
    rng = np.random.default_rng(22)
    src = rng.integers(2, vocab, (T5_BATCH, T5_SRC)).astype(np.int32)
    am = np.ones_like(src)
    for row, n in zip((1, 5), T5_PADDED):
        src[row, n:], am[row, n:] = 0, 0
    labels = rng.integers(2, vocab, (T5_BATCH, T5_TGT)).astype(np.int32)
    return src, am, labels


def plain_t5(p, cfg, src, am, dec, decisions=None):
    """T5ForConditionalGeneration's logits through the plain PyTorch
    versions of the kernels (``_reference``), differentiable by torch
    autograd: the twin the tape's step must meet.  ``p``: parameters by
    name; ``src`` / ``dec`` int64 and ``am`` {0, 1} float on the card;
    ``decisions``: a :class:`TapeDecisions` whose ReLU masks (the FFNs',
    encoder then decoder) the twin takes.  Float64 parameters evaluate it
    in float64 throughout."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch.models.t5 import _relative_position_bucket
    from lightgrad_tpu_torch.ops.elementwise import ew_reference
    from lightgrad_tpu_torch.ops.matmul import matmul_reference

    H, dk, D = cfg.num_heads, cfg.d_kv, cfg.d_model
    eps = cfg.layer_norm_epsilon
    (B, S), T = src.shape, dec.shape[1]
    dev = src.device

    f64 = p["shared.weight"].dtype == torch.float64

    def mm(a, b):
        return torch.matmul(a, b) if f64 else matmul_reference(a, b)

    def rms(x, name):
        var = (x * x).mean(-1, keepdim=True)
        return x * (var + eps) ** -0.5 * p[name]

    def lin(x, name):
        return mm(x, p[name].T)

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], H, dk).transpose(1, 2)

    def bias(stack, n, causal):
        rel = np.arange(n)[None, :] - np.arange(n)[:, None]
        ids = torch.from_numpy(_relative_position_bucket(
            rel, not causal, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance).astype(np.int64)).to(dev)
        table = p[f"{stack}.block.0.layer.0.SelfAttention."
                  "relative_attention_bias.weight"]
        return table[ids].permute(2, 0, 1)[None]

    def attend(x, kv, pre, adds):
        q, k, v = (heads(lin(t, pre + n + ".weight"))
                   for t, n in ((x, "q"), (kv, "k"), (kv, "v")))
        s = mm(q, k.transpose(-1, -2))
        for a in adds:
            s = s + a
        ctx = mm(torch.softmax(s, -1) if f64 else _PlainSoftmax.apply(s), v)
        return lin(ctx.transpose(1, 2).reshape(x.shape[0], -1, H * dk),
                   pre + "o.weight")

    def ff(x, pre):
        if cfg.is_gated_act:
            g = lin(x, pre + "wi_0.weight")
            g = F.gelu(g, approximate="tanh") if f64 \
                else ew_reference("f_gelu", g)
            h = g * lin(x, pre + "wi_1.weight")
        elif masks is not None:
            h = _MaskedRelu.apply(lin(x, pre + "wi.weight"), next(masks))
        else:
            h = torch.relu(lin(x, pre + "wi.weight"))
        return lin(h, pre + "wo.weight")

    masks = iter(decisions.relu) if decisions else None
    pad = ((1.0 - am) * -1e9).reshape(B, 1, 1, S)
    x = p["shared.weight"][src]
    eb = bias("encoder", S, False)
    for l in range(cfg.num_layers):
        pre = f"encoder.block.{l}.layer."
        h = rms(x, pre + "0.layer_norm.weight")
        x = x + attend(h, h, pre + "0.SelfAttention.", (eb, pad))
        x = x + ff(rms(x, pre + "1.layer_norm.weight"),
                   pre + "1.DenseReluDense.")
    enc = rms(x, "encoder.final_layer_norm.weight")
    y = p["shared.weight"][dec]
    db = bias("decoder", T, True)
    causal = torch.full((T, T), -1e9, device=dev).triu(1)
    for l in range(cfg.num_decoder_layers):
        pre = f"decoder.block.{l}.layer."
        h = rms(y, pre + "0.layer_norm.weight")
        y = y + attend(h, h, pre + "0.SelfAttention.", (db, causal))
        y = y + attend(rms(y, pre + "1.layer_norm.weight"), enc,
                       pre + "1.EncDecAttention.", (pad,))
        y = y + ff(rms(y, pre + "2.layer_norm.weight"),
                   pre + "2.DenseReluDense.")
    y = rms(y, "decoder.final_layer_norm.weight")
    if cfg.tie_word_embeddings:
        return mm(y * D ** -0.5, p["shared.weight"].T)
    return lin(y, "lm_head.weight")


def t5_train(name, model, batch, steps, card):
    """``steps`` Adafactor steps (lr T5_LR, no parameter scaling: HF's
    fine-tuning setting) of a T5 on the tape on one batch, step 1's logits
    and every gradient held to the plain twin; with more than one step the
    loss must fall, and tokens/s, peak memory and where a step's time goes
    are logged.  Returns the steps' launch counts."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg, f32 = model.cfg, torch.float32
    src, am, labels = batch
    dec = model.shift_right(labels)
    V = cfg.vocab_size
    x, m, d, y = (Tensor.from_numpy(a, requires_grad=False)
                  for a in (src, am, dec, labels.reshape(-1)))
    dev = x.data.device
    srcd, decd, yd = (torch.from_numpy(a).long().to(dev)
                      for a in (src, dec, labels.reshape(-1)))
    amd = torch.from_numpy(am).float().to(dev)
    n_params = sum(t.data.numel() for t in model.parameters())
    log(f"  {name}: {n_params / 1e6:.2f} M parameters; {src.shape[0]} x "
        f"{src.shape[1]} sources (rows 1, 5 padded to {T5_PADDED}), "
        f"{labels.shape[0]} x {labels.shape[1]} targets")

    def step_fn():
        logits = model(x, d, attention_mask=m)
        loss = lg_loss.cross_entropy(logits.reshape(-1, V), y)
        opt.zero_grad()
        loss.backward()
        return logits, loss

    opt = optim.Adafactor(list(model.parameters()), lr=T5_LR,
                          scale_parameter=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, host = [], [], []
    def twin(decisions=None, dtype=f32):
        ps = {n: t.data.detach().to(dtype).requires_grad_(True)
              for n, t in model.named_parameters()}
        logits = plain_t5(ps, cfg, srcd, amd.to(dtype), decd, decisions)
        loss = F.cross_entropy(logits.reshape(-1, V), yd)
        return logits.detach(), loss.item(), dict(zip(ps, torch.autograd.grad(
            loss, list(ps.values()))))

    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step == 0:
            with TapeDecisions() as decisions:
                logits, loss = step_fn()
        else:
            logits, loss = step_fn()
        host.append(time.perf_counter() - t0)   # forward + backward queued
        if step == 0:               # the checks' time is not the step's
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            plain_logits, plain_loss, grads = twin(decisions)
            grads64 = twin(decisions, torch.float64)[2]
            check_scaled(f"{name} logits vs the plain twin", f32,
                         logits.data, plain_logits, PATH_TOL[f32])
            log(f"  step-1 loss {loss.item():.5f}, plain twin "
                f"{plain_loss:.5f}")
            if decisions.relu:
                own = twin()[2]
                rel, worst = worst_rel({n: t.grad.data for n, t in
                                        model.named_parameters()}, own)
                log(f"  the twin takes the tape's {len(decisions.relu)} ReLU "
                    f"masks; with its own, its gradients are {rel:.3e} off "
                    f"({worst}: pre-activations that flip under rounding)")
                del own
            tape_grad_check(model, grads, grads64)
            del plain_logits, grads, grads64, decisions
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 += time.perf_counter() - c0
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        del logits, loss
    counts = launch_counts()
    if steps == 1:
        if not np.isfinite(losses[0]):
            raise AssertionError(f"{name}: loss {losses[0]}")
        log(f"  one Adafactor step: loss {losses[0]:.4f}, "
            f"{times[0] * 1e3:.1f} ms (compiles included); {card}")
        return counts
    peak = torch.cuda.max_memory_allocated()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    med = float(np.median(times[1:]))
    n_tok = src.size + labels.size
    log(f"  losses: {[round(v, 4) for v in losses]} "
        f"({'finite, falling' if ok else 'FAIL'})")
    log(f"  {n_tok} tokens a step ({src.size} source + {labels.size} "
        f"target): {n_tok / med:.1f} tok/s (median of steps 2-{steps}, "
        f"step times {[round(t, 4) for t in times]} s); peak memory of "
        f"steps 2-{steps} {peak / 2**30:.2f} GiB; {card}")
    log(f"  launches per step: "
        f"{ {k: v // steps for k, v in counts.items() if v} }")
    if not ok:
        raise AssertionError(f"{name}: loss not finite and falling: "
                             f"{losses}")
    step_breakdown(lambda: (step_fn(), opt.step()), med,
                   float(np.median(host[1:])))
    return counts


def t5_bias_scatter(cfg, card):
    """The encoder's relative-bias gradient as the tape computes it: the
    gather backward of the (S, S) bucket ids into the (buckets, heads)
    table, ``index_put_(..., accumulate=True)`` of S² rows of H; and the
    decoder's at its length.  Device ms of each, from a CUDA-only trace of
    10 calls."""
    from lightgrad_tpu_torch.models.t5 import _bucket_ids

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    H, nb = cfg.num_heads, cfg.relative_attention_num_buckets
    for what, n, causal in (("encoder", T5_SRC, False),
                            ("decoder", T5_TGT, True)):
        ids = _bucket_ids(0, n, n, causal, nb,
                          cfg.relative_attention_max_distance, dev)
        gd = torch.randn(n, n, H, generator=g, device=dev)

        def scatter():
            out = torch.zeros((nb, H), device=dev)
            out.index_put_((ids,), gd, accumulate=True)
            return out

        _, ms = traced_kernel_ms(lambda: [scatter() for _ in range(10)])
        log(f"  relative-bias gradient scatter, {what} ({n}² x {H} into "
            f"{nb} x {H}): {ms / 10:.4f} ms of device time a call "
            f"(index_put_ accumulate, sort included); {card}")


def t5_softmax_check(results):
    """The softmax kernel at T5-base's encoder scores, 8 x 12 x 512 x 512
    with the two padded sources' mask and a relative bias, fwd and bwd, in
    float32 and bfloat16, against the plain versions; timed by CUDA graph
    with L2 flushed beside torch.softmax / _softmax_backward_data (variant
    "t5_" of the softmax records)."""
    from lightgrad_tpu_torch.ops.softmax import (softmax_bwd,
                                                 softmax_bwd_reference,
                                                 softmax_fwd,
                                                 softmax_fwd_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)
    B, H, S = T5_BATCH, T5_BASE["num_heads"], T5_SRC
    mask = torch.zeros(B, 1, 1, S, device=dev)
    for row, n in zip((1, 5), T5_PADDED):
        mask[row, ..., n:] = -1e9
    bias = torch.randn(1, H, S, S, generator=g, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        tol, isz = KERNEL_TOL[dtype], torch.empty((), dtype=dtype) \
            .element_size()

        def scores():
            return (torch.randn(B, H, S, S, generator=g, device=dev) * 2.0
                    + bias + mask).to(dtype)

        sm = scores()
        ys, want = softmax_fwd(sm), softmax_fwd_reference(sm)
        tag = f"softmax_fwd T5-base encoder {tuple(sm.shape)}"
        err = check(tag, dtype, ys, want, tol)
        one_hot = torch.zeros_like(want).scatter_(-1, want.argmax(-1, True),
                                                  1.0)
        discriminates(tag, dtype, want, tol, torch.zeros_like(want), one_hot)
        sets = operand_sets(lambda: (scores(),))
        timed_sets(results, dtype, "softmax_fwd", err, softmax_fwd,
                   softmax_fwd_reference,
                   (2 * sm.numel() * isz, 5 * sm.numel()),
                   lambda t: torch.softmax(t, -1), sets, variant="t5_")
        del sets
        gs = torch.randn(B, H, S, S, generator=g, device=dev).to(dtype)
        want = softmax_bwd_reference(gs, ys)
        tag = f"softmax_bwd T5-base encoder {tuple(gs.shape)}"
        err = check(tag, dtype, softmax_bwd(gs, ys), want, tol)
        discriminates(tag, dtype, want, tol, torch.zeros_like(want))
        del sm, want
        sets = operand_sets(lambda: (
            torch.randn(B, H, S, S, generator=g, device=dev).to(dtype),
            softmax_fwd(scores())))
        timed_sets(results, dtype, "softmax_bwd", err, softmax_bwd,
                   softmax_bwd_reference,
                   (3 * gs.numel() * isz, 4 * gs.numel()),
                   lambda a, b: torch._softmax_backward_data(a, b, -1, dtype),
                   sets, variant="t5_")
        del sets, gs, ys
        torch.cuda.empty_cache()


def t5_serving(name, model, batch, card):
    """Phase 13a's serving: cached ``generate`` of T5_SERVE sources (one
    masked) for T5_NEW tokens after a warm-up that compiles the decode
    rows' softmax widths (wall and device ms a token, idle share); the
    first T5_UNCACHED tokens again with ``use_cache=False``;
    ``generate_compiled`` of source 0 against its eager greedy tokens; beam
    4 and beam 1 (== those greedy tokens) for T5_BEAM[1] tokens.  Returns {path: launch
    counts}."""
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    src, am, _ = batch
    n = T5_SERVE
    x, m = (Tensor.from_numpy(a[:n], requires_grad=False) for a in (src, am))
    x1, m1 = (Tensor.from_numpy(a[:1], requires_grad=False)
              for a in (src, am))
    counts = {}
    t0 = time.perf_counter()
    model.generate(Tensor.from_numpy(src[:1, :16], requires_grad=False),
                   max_new_tokens=T5_NEW)
    log(f"  warm-up generate (1 x 16 source, {T5_NEW} tokens: the decode "
        f"rows' softmax widths compile): {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(x, max_new_tokens=T5_NEW, attention_mask=m)
    wall = (time.perf_counter() - t0) * 1e3
    counts[f"{name} generate (cached)"] = launch_counts()
    ntok = out.shape[1]
    traced, dev_ms = traced_kernel_ms(lambda: model.generate(
        x, max_new_tokens=T5_TRACED, attention_mask=m))
    dev_ms /= traced.shape[1]
    log(f"  generate, {n} x {T5_SRC} sources (row 1 masked past "
        f"{T5_PADDED[0]}), cached: {ntok} tokens a row in {wall:.1f} ms: "
        f"{wall / ntok:.2f} ms a token step ({n} rows), device "
        f"{dev_ms:.2f} ms a step over the first {traced.shape[1]} (idle "
        f"{100 * (1 - dev_ms * ntok / wall):.1f}%; the encoder included); "
        f"softmax launches "
        f"{counts[f'{name} generate (cached)']['softmax_fwd']}; {card}")
    slow = model.generate(x, max_new_tokens=T5_UNCACHED, attention_mask=m,
                          use_cache=False)
    same = np.array_equal(slow, out[:, :T5_UNCACHED])
    log(f"  use_cache=False, {T5_UNCACHED} tokens: "
        f"{'the cached tokens' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: uncached tokens {slow.tolist()} != "
                             f"cached {out[:, :T5_UNCACHED].tolist()}")
    # source 0 alone, greedy: what compiled decoding and beam 1 must give
    eager = model.generate(x1, max_new_tokens=T5_NEW, attention_mask=m1)[0]
    torch.cuda.synchronize()
    model.generate_compiled(src[0], max_new_tokens=4)      # a warm-up call
    t0 = time.perf_counter()
    comp = model.generate_compiled(src[0], max_new_tokens=T5_NEW)
    cwall = (time.perf_counter() - t0) * 1e3
    same = np.array_equal(comp, eager[:len(comp)])
    log(f"  generate_compiled, 1 x {T5_SRC} source, {len(comp)} tokens: "
        f"{cwall / len(comp):.2f} ms a token (the encoder included); the "
        f"eager tokens: {'yes' if same else 'FAIL'}; {card}")
    if not same:
        raise AssertionError(f"{name}: compiled {comp.tolist()} != eager "
                             f"{eager.tolist()}")
    beam, nb = T5_BEAM
    reset_launch_counts()
    t0 = time.perf_counter()
    b4 = model.beam_generate(x1, max_new_tokens=nb, beam_size=beam,
                             attention_mask=m1)
    bwall = time.perf_counter() - t0
    counts[f"{name} beam_generate"] = launch_counts()
    b1 = model.beam_generate(x1, max_new_tokens=nb, beam_size=1,
                             attention_mask=m1)
    same = np.array_equal(b1, eager[:len(b1)])
    log(f"  beam_generate beam {beam}, {nb} tokens: {len(b4)} tokens in "
        f"{bwall:.2f} s; beam 1 is greedy: {'yes' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: beam 1 {b1.tolist()} != greedy "
                             f"{eager[:len(b1)].tolist()}")
    return counts


def t5_bf16_check(name, model, batch):
    """The model cast to bf16 (``amp.cast_module``): one teacher-forced
    forward stays bf16 -- every softmax the tape launches takes bf16 scores,
    the logits are bf16 -- and its logits are within PATH_TOL[bf16] of the
    f32 twin on the cast weights."""
    from lightgrad_tpu_torch import amp, no_grad
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.autograd.cuda import ops as cuda_ops

    src, am, labels = batch
    dec = model.shift_right(labels)
    amp.cast_module(model, torch.bfloat16)
    seen = []
    fwd = cuda_ops.ksoftmax_fwd

    def spy(x):
        seen.append(x.dtype)
        return fwd(x)

    cuda_ops.ksoftmax_fwd = spy
    try:
        with no_grad():
            logits = model(*(Tensor.from_numpy(a, requires_grad=False)
                             for a in (src, dec)),
                           attention_mask=Tensor.from_numpy(
                               am, requires_grad=False)).data
    finally:
        cuda_ops.ksoftmax_fwd = fwd
    dev = logits.device
    with torch.no_grad():
        want = plain_t5({n: t.data.float() for n, t in
                         model.named_parameters()}, model.cfg,
                        torch.from_numpy(src).long().to(dev),
                        torch.from_numpy(am).float().to(dev),
                        torch.from_numpy(dec).long().to(dev))
    kinds = sorted({str(t)[6:] for t in seen})
    log(f"  bf16 cast: {len(seen)} softmax launches, dtypes {kinds}; "
        f"logits {str(logits.dtype)[6:]}")
    if logits.dtype != torch.bfloat16 or kinds != ["bfloat16"]:
        raise AssertionError(f"{name} bf16: left bf16 ({kinds}, logits "
                             f"{logits.dtype})")
    check_scaled(f"{name} bf16 logits vs the f32 twin", torch.bfloat16,
                 logits, want, PATH_TOL[torch.bfloat16])


def phase_t5(card, results):
    """Phase 13a-b: T5-base (HF google-t5/t5-base's widths, not cut; seeded
    random weights, dropout off) on the tape: the softmax kernel at its
    encoder scores; T5_STEPS float32 Adafactor steps on T5_BATCH x T5_SRC
    sources and T5_BATCH x T5_TGT targets, step 1 against the plain twin,
    the relative-bias scatter's device time; serving (cached, uncached,
    compiled, beam); one bf16 forward of the cast model.  Then
    flan-T5-base's gated FFN and untied head: one step against its twin,
    ``generate_compiled`` for FLAN_COMPILED tokens equal to eager.  Returns
    {path: launch counts}."""
    t0 = time.perf_counter()
    t5_softmax_check(results)
    log(f"  softmax at T5-base's encoder scores: "
        f"{time.perf_counter() - t0:.1f} s")
    counts = {}
    name = "T5-base"
    model = t5_model(T5_BASE)
    batch = t5_batch(model.cfg.vocab_size)
    t0 = time.perf_counter()
    counts[f"{name} training"] = t5_train(name, model, batch, T5_STEPS, card)
    t5_bias_scatter(model.cfg, card)
    log(f"  {name} training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts.update(t5_serving(name, model, batch, card))
    log(f"  {name} serving: {time.perf_counter() - t0:.1f} s")
    t5_bf16_check(name, model, batch)
    del model
    torch.cuda.empty_cache()
    name = "flan-T5-base"
    log(f"{name}'s gated-GELU FFN (2048) and untied head, float32 "
        f"Adafactor:")
    t0 = time.perf_counter()
    model = t5_model(FLAN_T5_BASE)
    counts[f"{name} training"] = t5_train(name, model, batch, 1, card)
    src = batch[0][0]
    comp = model.generate_compiled(src, max_new_tokens=FLAN_COMPILED)
    from lightgrad_tpu_torch.autograd import Tensor

    eager = model.generate(Tensor.from_numpy(src[None], requires_grad=False),
                           max_new_tokens=FLAN_COMPILED)[0]
    same = np.array_equal(comp, eager[:len(comp)])
    log(f"  generate_compiled, {len(comp)} tokens: the eager tokens: "
        f"{'yes' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: compiled {comp.tolist()} != eager "
                             f"{eager.tolist()}")
    del model
    torch.cuda.empty_cache()
    log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return counts


def moe_routing_check(name, model, plain_out):
    """Each MoE layer's routing against the plain twin's, which took the
    model's expert choices: the kept and dropped routings equal; the twin's
    own choices equal the model's at every token whose top-(k+1)
    probabilities lie more than 10x the two evaluations' deviation apart
    (there a flip is arithmetically impossible)."""
    n_tok = n_dec = n_drop = 0
    for l, (block, (_, _, own, kept, probs)) in enumerate(zip(
            [b for b in model.h if hasattr(b, "moe")], plain_out)):
        ids, keep = block.moe.routes
        if not torch.equal(keep, kept):
            raise AssertionError(f"{name}: layer {l} keeps "
                                 f"{int(keep.sum())} routings, the twin "
                                 f"{int(kept.sum())} ({int((keep != kept).sum())} "
                                 f"differ)")
        k = ids.shape[0]
        dev = (block.moe.router_probs - probs).abs().amax(-1)
        top = probs.topk(k + 1, -1).values
        gaps = (top[:, :-1] - top[:, 1:]).amin(-1)
        decisive = gaps > 10 * dev.clamp_min(1e-7)
        bad = decisive & (own != ids).any(0)
        if bad.any():
            raise AssertionError(f"{name}: layer {l} routes {int(bad.sum())} "
                                 f"decisive tokens otherwise than the twin")
        n_tok += ids.shape[1]
        n_dec += int(decisive.sum())
        n_drop += int((~keep).sum())
    log(f"  routing: kept / dropped routings of every layer equal the "
        f"twin's ({n_drop} of {k * n_tok} dropped); {n_dec} of {n_tok} "
        f"(token, layer) choices decisive, all the twin's own there")


def moe_product_check(cfg, results):
    """The matmul kernel at an expert product of the GPT-MoE step, (E, C,
    d) @ (E, d, h) with C the capacity of 8 x 1024 tokens, f32 and bf16,
    against the plain version; timed by CUDA graph beside torch.matmul
    (variant "moe_up_" of the matmul record)."""
    from lightgrad_tpu_torch.models._torch_layers import moe_capacity
    from lightgrad_tpu_torch.ops.matmul import matmul, matmul_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    E, d, h = cfg.n_experts, cfg.n_embd, cfg.moe_hidden
    C = moe_capacity(cfg.moe_k, TRAIN_BATCH * cfg.n_positions, E,
                     cfg.moe_capacity_factor)
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn(E, C, d, generator=g, device=dev).to(dtype)
        b = (torch.randn(E, d, h, generator=g, device=dev)
             * d ** -0.5).to(dtype)
        want = matmul_reference(a, b)
        err = check(f"matmul expert product ({E}, {C}, {d}) @ ({E}, {d}, "
                    f"{h})", dtype, matmul(a, b), want, KERNEL_TOL[dtype])
        discriminates("matmul expert product", dtype, want,
                      KERNEL_TOL[dtype], torch.zeros_like(want))
        ops = 2 * E * C * d * h
        isz = a.element_size()
        timed(results, dtype, "matmul", err, lambda: matmul(a, b),
              lambda: matmul_reference(a, b),
              ((E * C * d + E * d * h + E * C * h) * isz,
               ops if dtype == torch.bfloat16 else 3 * ops),
              lambda: torch.matmul(a, b), 10, variant="moe_up_",
              peak=None if dtype == torch.bfloat16 else TF32_OPS)
        del a, b, want
        torch.cuda.empty_cache()


def phase_gpt_moe(card, results):
    """Phase 13c: GPT-MoE at GPT-2 small's widths (GPT_MOE: 8 experts of
    3072 in every block, top-2 at capacity factor 1.25; seeded random
    weights) trained with f32 AdamW on TRAIN_BATCH x 1024 tokens, loss CE +
    MOE_AUX aux_loss, MOE_STEPS steps: step 1's logits, aux_loss and
    gradients against the plain twin (``moe_reference``'s one-hot
    products on the model's expert choices), the routing check, the loss
    falls; tokens/s, device ms and idle share of a step, peak memory, the
    expert products' launches.  Then one bf16 ``MixedPrecision`` AdamW step
    and one f32 step of the Switch-style model (GPT_SWITCH).  Returns
    {path: launch counts}."""
    import torch.nn.functional as F

    from lightgrad_tpu_torch import GPT, GPTConfig, amp, optim
    from lightgrad_tpu_torch.loss import cross_entropy
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    cfg = GPTConfig(**GPT_MOE)
    moe_product_check(cfg, results)
    name = "GPT-MoE (GPT-2 small, 8 experts, top-2)"
    model = GPT(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    B, T, V = TRAIN_BATCH, cfg.n_positions, cfg.vocab_size
    g = torch.Generator(device=dev).manual_seed(23)
    ids = torch.randint(0, V, (B, T), generator=g, device=dev)
    tgt = torch.randint(0, V, (B * T,), generator=g, device=dev)
    params = dict(model.named_parameters())
    n = sum(t.numel() for t in params.values())
    log(f"  {name}: {n / 1e6:.1f} M parameters, {B} x {T} tokens")

    def loss_of(m):
        logits = m(ids)
        return logits, cross_entropy(logits.reshape(B * T, V), tgt) \
            + MOE_AUX * m.aux_loss

    def twin_check(logits):
        """Step 1 of the plain twin on the model's weights and expert
        choices, held to the model's step."""
        ps = {k: t.detach().requires_grad_(True) for k, t in params.items()}
        routes = {l: b.moe.routes[0] for l, b in enumerate(model.h)
                  if hasattr(b, "moe")}
        out = []
        plain = plain_forward(model, ids, p=ps, routes=routes, moe_out=out)
        aux = sum(o[0] for o in out)
        loss = F.cross_entropy(plain.reshape(B * T, V), tgt) + MOE_AUX * aux
        grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
        check(f"{name} logits vs the plain twin", torch.float32,
              logits.detach(), plain.detach(), PATH_TOL[torch.float32])
        check(f"{name} aux_loss vs the plain twin", torch.float32,
              model.aux_loss.detach().reshape(1), aux.detach().reshape(1),
              PATH_TOL[torch.float32])
        log(f"  step-1 loss (CE + {MOE_AUX} aux) plain twin {loss.item():.5f}")
        moe_routing_check(name, model, out)
        grad_check(params, grads, torch.float32)

    opt = optim.AdamW(model.parameters(), lr=MOE_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    counts = {}
    losses, times = [], []
    for step in range(MOE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, loss = loss_of(model)
        opt.zero_grad()
        loss.backward()
        if step == 0:               # the checks' time is not the step's
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            log(f"  step-1 loss {loss.item():.5f}")
            twin_check(logits)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 += time.perf_counter() - c0
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        del logits, loss
    counts[f"{name} training"] = c = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    med = float(np.median(times[1:]))

    def one_step():
        _, loss = loss_of(model)
        opt.zero_grad()
        loss.backward()
        opt.step()

    fams, busy, wall = traced_families(one_step, (
        ("gemm", "cuBLAS"), ("nvjet", "cuBLAS"), ("cutlass", "cuBLAS"),
        ("adam", "optimizer")))
    n_moe = sum(hasattr(b, "moe") for b in model.h)
    log(f"  losses: {[round(v, 4) for v in losses]} "
        f"({'finite, falling' if ok else 'FAIL'})")
    log(f"  {B}x{T} tokens a step: {B * T / med:.1f} tok/s (median of steps "
        f"2-{MOE_STEPS}, step times {[round(t, 4) for t in times]} s); a "
        f"traced step: device {busy:.1f} ms of {wall:.1f} ms (idle "
        f"{100 * (1 - busy / wall):.1f}%); peak memory of steps "
        f"2-{MOE_STEPS} {peak / 2**30:.2f} GiB; expert-product launches of "
        f"the matmul kernel {c['matmul'] // MOE_STEPS} a step ({n_moe} MoE "
        f"blocks x 2 products x (1 forward + 2 backward)); {card}")
    log("  device ms (kernels) of the traced step by family: " + ", ".join(
        f"{f} {ms:.2f} ({n})" for f, (ms, n) in sorted(
            fams.items(), key=lambda kv: -kv[1][0])))
    if not ok:
        raise AssertionError(f"{name}: loss not finite and falling: "
                             f"{losses}")
    if c["matmul"] != MOE_STEPS * n_moe * 6:
        raise AssertionError(f"{name}: {c['matmul']} matmul launches, not "
                             f"{MOE_STEPS * n_moe * 6}")
    del opt
    torch.cuda.empty_cache()

    def moved_step(tag, m, zero, scale, step, masters):
        before = [t.detach().clone() for t in masters]
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = loss_of(m)
        zero()
        scale(loss).backward()
        step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts[tag] = launch_counts()
        moved = sum(not torch.equal(t, b) for t, b in zip(masters, before))
        log(f"  {tag}: loss {loss.item():.4f}, {moved} of {len(before)} "
            f"parameters moved, {dt * 1e3:.1f} ms; {card}")
        if not np.isfinite(loss.item()) or moved != len(before):
            raise AssertionError(f"{tag}: loss {loss.item()}, {moved} of "
                                 f"{len(before)} moved")

    mp = amp.MixedPrecision(model, lambda ps: optim.AdamW(ps, lr=MOE_LR))
    moved_step(f"{name} bf16 MixedPrecision AdamW step", model, mp.zero_grad,
               mp.scale, mp.step, mp.masters)
    del model, mp
    torch.cuda.empty_cache()
    model = GPT(GPTConfig(**GPT_SWITCH), device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
    opt = optim.AdamW(model.parameters(), lr=MOE_LR)
    tag = "GPT-MoE Switch-style (top-1, every other block)"
    moved_step(f"{tag} f32 AdamW step", model, opt.zero_grad, lambda l: l,
               opt.step, list(model.parameters()))
    del model, opt
    torch.cuda.empty_cache()
    return counts


# --- phase 14: the parallel layer at world size 1 -------------------------
# the ring's chunked merge at Mistral-7B's attention width: 32 heads of 128,
# S 8192 in RING_CHUNKS chunks (a 4-rank ring's rounds on one card)
RING_HEADS, RING_HD, RING_SEQ, RING_CHUNKS = 32, 128, 8192, 4
# the plain version runs on RING_PLAIN_HEADS of the heads (its (S, S) f32
# scores are 256 MiB a head)
RING_PLAIN_HEADS = 2
# GPT-2 small through pipeline_train_1f1b at pp = 1: PIPE_MICRO microbatches
# of PIPE_MB x PIPE_SEQ tokens
PIPE_MICRO, PIPE_MB, PIPE_SEQ = 2, 2, 512
PARALLEL_BERT_KERNELS = ("flash_block", "matmul", "elementwise", "reduce",
                         "layernorm_fwd", "layernorm_bwd")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _bert_pair(cfg, mesh):
    """Two BERTs of the same weights: whole, and sharded by BERT_TP_RULES
    with ring attention on ``mesh``'s sp axis."""
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.models.bert import BertForMaskedLM
    from lightgrad_tpu_torch.parallel import (BERT_TP_RULES,
                                              enable_sequence_parallel,
                                              shard_module)

    lg_random.seed(0)
    plain = BertForMaskedLM(cfg)
    lg_random.seed(0)
    par = BertForMaskedLM(cfg)
    shard_module(par, mesh, BERT_TP_RULES)
    n = enable_sequence_parallel(par, mesh, axis="sp")
    if n != cfg.num_hidden_layers:
        raise AssertionError(f"ring attention on {n} of "
                             f"{cfg.num_hidden_layers} layers")
    return plain, par


def _rel(got, want):
    got, want = got.double(), want.double()
    return (got - want).abs().max().item() / max(
        want.abs().max().item(), 1e-30)


def _hold(what, dtype, pairs, tol, ref_of=lambda n: n):
    """Every (name, got, want) within tol of max |want| (of ``ref_of``'s
    entry: a zero-gradient key bias is held against its query bias')."""
    want = {n: w for n, _, w in pairs}
    rel = {n: (g.double() - w.double()).abs().max().item() / max(
        want[ref_of(n)].double().abs().max().item(), 1e-30)
        for n, g, w in pairs}
    worst = max(rel, key=rel.get)
    ok = rel[worst] <= tol and all(torch.isfinite(g.float()).all()
                                   for _, g, _ in pairs)
    log(f"  {what} {str(dtype)[6:]}: {len(pairs)} tensors, worst rel "
        f"{rel[worst]:.3e} ({worst}) tol {tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} {dtype}: {worst} rel {rel[worst]}")


def phase_parallel(card):
    """Phase 14: the parallel layer on NCCL at world size 1 (one card; NCCL
    takes one GPU a rank, so the multi-rank paths are tested on CPU ranks).
    BERT-base on the tape under BERT_TP_RULES and ring attention at
    make_mesh(dp=1, tp=1, sp=1), one step in f32 AdamW and one in bf16
    MixedPrecision AdamW, each held to the same step of a whole model;
    the ring's chunked merge at Mistral-7B's attention width in f32 and
    bf16 against one flash call and the plain version, timed against the
    one call; GPT-2 small's blocks through pipeline_train_1f1b at pp = 1
    against the unpipelined step; GPT-2 small's cached decode at tp = 1
    against the whole model's tokens; a sharded checkpoint round trip.
    Returns {path: launch counts}."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from lightgrad_tpu_torch import GPT, GPTConfig, amp, optim
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.autograd.cuda.device import default_device
    from lightgrad_tpu_torch.checkpoint import (load_checkpoint_sharded,
                                                save_checkpoint_sharded)
    from lightgrad_tpu_torch.models.bert import BertConfig
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                                   attention_fwd_reference,
                                                   attention_fwd_res)
    from lightgrad_tpu_torch.parallel import (GPT_TP_RULES, distributed,
                                              make_mesh, pipeline_train_1f1b,
                                              shard_module)
    from lightgrad_tpu_torch.parallel.ring_attention import ring_local

    dev = default_device()
    kind = dev.type
    counts = {}
    t0 = time.perf_counter()
    distributed.initialize(f"localhost:{_free_port()}", 1, 0, device=kind)
    try:
        mesh = make_mesh(dp=1, tp=1, sp=1, devices=kind)
        log(f"  {'NCCL' if kind == 'cuda' else 'gloo'} at world size "
            f"{dist.get_world_size()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}; "
            f"{time.perf_counter() - t0:.1f} s to join")

        # (1) BERT-base, one f32 AdamW step and one bf16 AMP step
        cfg = BertConfig(**BERT_BASE)
        ids, _, labels, _ = bert_batch(cfg)
        x = Tensor(torch.tensor(ids, device=dev), requires_grad=False)
        y = Tensor(torch.tensor(labels, device=dev), requires_grad=False)

        def loss_of(m):
            return lg_loss.cross_entropy(
                m(x).reshape(-1, cfg.vocab_size), y, ignore_index=-100)

        key_to_query = lambda n: n.replace(".key.bias", ".query.bias")
        for dtype in (torch.float32, torch.bfloat16):
            plain, par = _bert_pair(cfg, mesh)
            runs = {}
            for name, m in (("whole", plain), ("sharded", par)):
                if dtype == torch.float32:
                    opt = optim.AdamW(list(m.parameters()), lr=BERT_LR)
                    step_opt, zero, scale = opt.step, opt.zero_grad, None
                    masters = list(m.parameters())
                else:
                    mp = amp.MixedPrecision(
                        m, lambda ps: optim.AdamW(ps, lr=BERT_LR))
                    step_opt, zero, scale = mp.step, mp.zero_grad, mp.scale
                    masters = mp.masters
                reset_launch_counts()
                torch.cuda.synchronize() if kind == "cuda" else None
                t1 = time.perf_counter()
                loss = loss_of(m)
                zero()
                (scale(loss) if scale else loss).backward()
                grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
                step_opt()
                torch.cuda.synchronize() if kind == "cuda" else None
                runs[name] = (loss.item(), grads,
                              [t.numpy() for t in masters],
                              time.perf_counter() - t1)
                if name == "sharded":
                    counts[f"BERT-base sharded + ring, {str(dtype)[6:]}"] = \
                        launch_counts()
            (l0, g0, p0, s0), (l1, g1, p1, s1) = runs["whole"], runs["sharded"]
            log(f"  BERT-base {str(dtype)[6:]} step: loss whole {l0:.6f}, "
                f"sharded + ring {l1:.6f}; {s0 * 1e3:.1f} / {s1 * 1e3:.1f} "
                f"ms (first step, builds included); {card}")
            tol = PATH_TOL[dtype]
            if abs(l1 - l0) > tol * max(abs(l0), 1.0):
                raise AssertionError(f"BERT loss {l1} vs {l0}")
            t = lambda a: torch.from_numpy(np.asarray(a))     # noqa: E731
            _hold("BERT-base gradients, sharded + ring vs whole", dtype,
                  [(n, t(g1[n]), t(g0[n])) for n in g0], tol, key_to_query)
            _hold("BERT-base parameters after the step", dtype,
                  [(str(i), t(a), t(b)) for i, (a, b) in
                   enumerate(zip(p1, p0))], tol)
            if dtype == torch.float32:
                ckpt_model = par
            else:
                del par
            del plain
        torch.cuda.empty_cache() if kind == "cuda" else None

        # (2) the ring's chunked merge at Mistral-7B's attention width
        g = torch.Generator(device=dev).manual_seed(14)
        sc = RING_HD ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, go = (torch.randn(RING_HEADS, RING_SEQ, RING_HD,
                                       generator=g, device=dev).to(dtype)
                           for _ in range(4))
            tol = KERNEL_TOL[dtype]
            reset_launch_counts()
            out, dq, dk, dv = ring_local(q, k, v, go, sc, RING_CHUNKS, True)
            counts[f"ring merge, {str(dtype)[6:]}"] = launch_counts()
            f_out, f_lse = attention_fwd_res(q, k, v, sc, True)
            want = attention_bwd(go, q, k, v, sc, True, out=f_out,
                                 lse=f_lse)
            tag = (f"ring merge ({RING_HEADS}, {RING_SEQ}, {RING_HD}) "
                   f"causal, {RING_CHUNKS} chunks vs one flash call")
            check_ulp(f"{tag} out", dtype, out, f_out, FWD_TOL[dtype])
            for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                check(f"{tag} {n}", dtype, a, b, tol)
            # the plain version on RING_PLAIN_HEADS heads
            h = RING_PLAIN_HEADS
            ps = [t[:h].float().requires_grad_(True) for t in (q, k, v)]
            p_out = attention_fwd_reference(*ps, sc, True)[0]
            p_out.backward(go[:h].float())
            tag = f"ring merge vs the plain version ({h} heads)"
            check_ulp(f"{tag} out", dtype, out[:h], p_out.detach(),
                      FWD_TOL[dtype])
            for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ps):
                check(f"{tag} {n}", dtype, a[:h], b.grad, tol)
            del ps, p_out
            if kind == "cuda":
                ring_ms = cuda_ms(lambda: ring_local(q, k, v, go, sc,
                                                     RING_CHUNKS, True),
                                  iters=3)
                one_ms = cuda_ms(lambda: _one_flash(q, k, v, go, sc),
                                 iters=3)
                log(f"  {str(dtype)[6:]}: forward + backward {ring_ms:.2f} "
                    f"ms in {RING_CHUNKS} chunks "
                    f"({RING_CHUNKS * (RING_CHUNKS + 1) // 2} blocks), "
                    f"{one_ms:.2f} ms in one flash call; {card}")
            del q, k, v, go, out, dq, dk, dv, f_out, f_lse, want
            torch.cuda.empty_cache() if kind == "cuda" else None

        # (3) GPT-2 small's blocks through pipeline_train_1f1b at pp = 1
        pmesh = make_mesh(dp=1, tp=1, pp=1, devices=kind)
        gcfg = GPTConfig(**GPT2_SMALL)
        model = GPT(gcfg, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
        V = gcfg.vocab_size
        tok = torch.randint(0, V, (PIPE_MICRO, PIPE_MB, PIPE_SEQ + 1),
                            generator=g, device=dev)
        with torch.no_grad():
            pos = torch.arange(PIPE_SEQ, device=dev)
            xm = model.wte(tok[..., :-1]) + model.wpe(pos)
        ym = tok[..., 1:]
        # the stage: all 12 blocks (pp = 1), their parameters stacked (1, ...)
        stacked = {n: p.detach()[None] for n, p in
                   model.h.named_parameters()}

        def head_loss(h, t):
            logits = model.ln_f(h) @ model.wte.weight.T
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, V), t.reshape(-1))

        reset_launch_counts()
        t1 = time.perf_counter()
        loss, grads = pipeline_train_1f1b(
            lambda p, h: _seq_blocks(model.h, h, p), head_loss, stacked, xm,
            ym, pmesh)
        torch.cuda.synchronize() if kind == "cuda" else None
        pipe_s = time.perf_counter() - t1
        counts["GPT-2 small 1F1B, pp 1"] = launch_counts()
        model.zero_grad()
        want = sum(head_loss(_seq_blocks(model.h, xm[m]), ym[m])
                   for m in range(PIPE_MICRO)) / PIPE_MICRO
        want.backward()
        log(f"  GPT-2 small 1F1B at pp 1, {PIPE_MICRO} x {PIPE_MB} x "
            f"{PIPE_SEQ} tokens: loss {loss.item():.6f}, unpipelined "
            f"{want.item():.6f}; {pipe_s * 1e3:.1f} ms (first call); {card}")
        if abs(loss.item() - want.item()) > PATH_TOL[torch.float32] * \
                max(abs(want.item()), 1.0):
            raise AssertionError(f"1F1B loss {loss.item()} vs "
                                 f"{want.item()}")
        _hold("GPT-2 small 1F1B gradients vs the unpipelined step",
              torch.float32,
              [(n, grads[n].full_tensor()[0], p.grad)
               for n, p in model.h.named_parameters()],
              PATH_TOL[torch.float32])

        # (4) cached decode at tp = 1
        ids = torch.randint(0, V, (16,), generator=g, device=dev).tolist()
        want_tok = model.generate(ids, max_new_tokens=16, use_cache=True)
        tmesh = make_mesh(dp=1, tp=1, devices=kind)
        shard_module(model, tmesh, GPT_TP_RULES)
        reset_launch_counts()
        got_tok = model.generate(ids, max_new_tokens=16, use_cache=True)
        counts["GPT-2 small decode, tp 1"] = launch_counts()
        same = got_tok == want_tok
        log(f"  GPT-2 small cached decode at tp 1, 16 new tokens: "
            f"{'the whole model' if same else 'NOT the whole model'}'s "
            f"tokens")
        if not same:
            raise AssertionError(f"tp decode {got_tok} vs {want_tok}")
        del model

        # (5) a sharded checkpoint round trip (the f32 BERT after its step)
        path = tempfile.mkdtemp(prefix="lg_sharded_")
        try:
            save_checkpoint_sharded(path, ckpt_model, step=1)
            before = {n: p.numpy() for n, p in
                      ckpt_model.named_parameters()}
            for p in ckpt_model.parameters():
                p._set_data(torch.zeros_like(p.data))
            meta = load_checkpoint_sharded(path, ckpt_model)
            same = all(np.array_equal(p.numpy(), before[n])
                       for n, p in ckpt_model.named_parameters())
            log(f"  sharded checkpoint round trip: {len(before)} "
                f"parameters {'bit for bit' if same else 'DIFFER'}, meta "
                f"{meta}")
            if not same or meta != {"step": 1}:
                raise AssertionError("sharded checkpoint round trip")
        finally:
            shutil.rmtree(path, ignore_errors=True)
        del ckpt_model
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache() if kind == "cuda" else None
    return counts


def _seq_blocks(h, x, params=None):
    """GPT blocks ``h`` (a ModuleList) in order on ``x``; with ``params``
    {"i.name": tensor} in place of their own (a pipeline stage)."""
    for i, b in enumerate(h):
        if params is None:
            x = b(x)
        else:
            x = torch.func.functional_call(
                b, {n: params[f"{i}.{n}"] for n, _ in b.named_parameters()},
                (x,))
    return x


def _one_flash(q, k, v, g, sc):
    from lightgrad_tpu_torch.ops.attention import (attention_bwd,
                                                   attention_fwd_res)

    out, lse = attention_fwd_res(q, k, v, sc, True)
    return attention_bwd(g, q, k, v, sc, True, out=out, lse=lse)


def ddpm_checks(out, card):
    """Phase 15's checks of the DDPM example after its run (``out``: what
    ``diffusion.main`` returned), at the trained weights: on a batch of
    DDPM_BATCH synthetic digits with timesteps and noise drawn on the card,
    the loss and every gradient against the plain twin (PATH_TOL); one
    profiled step (the example's own ``train_step``): device ms and idle
    share; one ``p_sample`` step against the twin with the same noise;
    under ``ema.average_parameters()``, DDPM_SAMPLES images by
    ``sample_ddim`` (DDIM_STEPS hops, eta 0), wall and device time,
    repeated bit for bit.  Returns {path: launch counts}."""
    from lightgrad_tpu_torch import data, no_grad
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.examples.diffusion import train_step
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    dif, opt, ema = out["diffusion"], out["optim"], out["ema"]
    unet, f32, B, T = dif.model, torch.float32, DDPM_BATCH, dif.T
    dev = unet.out.w.data.device
    digits = data.MNIST(train=True, n=B, shuffle=False).tensors[0]
    g = torch.Generator(device=dev).manual_seed(15)
    x0 = Tensor(digits.data.reshape(B, 1, 28, 28) * 2.0 - 1.0,
                requires_grad=False)
    t = Tensor(torch.randint(0, T, (B,), generator=g, device=dev,
                             dtype=torch.int32), requires_grad=False)
    z = Tensor(torch.randn(B, 1, 28, 28, generator=g, device=dev),
               requires_grad=False)

    loss = dif.loss(x0, t, z)
    for p in unet.parameters():
        p.zero_grad()
    loss.backward()
    ps = {n: p.data.detach().clone().requires_grad_(True)
          for n, p in unet.named_parameters()}
    tl = t.data.long()
    c1 = dif.sqrt_a_bar.data[tl].reshape(B, 1, 1, 1)
    c2 = dif.sqrt_1m_a_bar.data[tl].reshape(B, 1, 1, 1)
    err = plain_unet(ps, unet, x0.data * c1 + z.data * c2,
                     t.data.float()) - z.data
    plain = (err * err).mean() * 0.5
    grads = dict(zip(ps, torch.autograd.grad(plain, list(ps.values()))))
    log(f"  at the trained weights: loss {loss.item():.6f}, plain twin "
        f"{plain.item():.6f}")
    if abs(loss.item() - plain.item()) > PATH_TOL[f32] * max(
            1.0, abs(plain.item())):
        raise AssertionError("DDPM loss off the plain twin")
    tape_grad_check(unet, grads)
    for p in unet.parameters():
        p.zero_grad()

    reset_launch_counts()
    busy, wall = busy_share(lambda: train_step(dif, opt, ema, x0, t, z))
    per_step = {k: v for k, v in launch_counts().items() if v}
    log(f"  profiled step: device {busy:.2f} of {wall:.2f} ms (idle "
        f"{100 * (1 - busy / wall):.1f}%); launches a step {per_step}")

    xt = torch.randn(B, 1, 28, 28, generator=g, device=dev)
    noise = torch.randn(B, 1, 28, 28, generator=g, device=dev)
    tt = torch.full((B,), T // 2, dtype=torch.int32, device=dev)
    with no_grad():
        got = dif.p_sample(Tensor(xt, requires_grad=False),
                           Tensor(tt, requires_grad=False),
                           Tensor(noise, requires_grad=False)).data
    with torch.no_grad():
        ps = {n: p.data for n, p in unet.named_parameters()}
        eps = plain_unet(ps, unet, xt, tt.float())
        tl = tt.long()
        want = (xt - eps * dif.eps_coef.data[tl].reshape(B, 1, 1, 1)) \
            * dif.rsqrt_alphas.data[tl].reshape(B, 1, 1, 1) \
            + noise * dif.post_std.data[tl].reshape(B, 1, 1, 1)
    check("DDPM p_sample at t = T/2 vs the plain twin", f32, got, want,
          PATH_TOL[f32])

    n = DDPM_SAMPLES
    with ema.average_parameters():
        reset_launch_counts()
        run = lambda: dif.sample_ddim(n, steps=DDIM_STEPS, eta=0.0, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = run().data
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        again, busy = traced_kernel_ms(lambda: run().data)
        finite, same = bool(torch.isfinite(imgs).all()), torch.equal(
            imgs, again)
        log(f"  sample_ddim: {n} images {tuple(imgs.shape)} in {wall:.2f} s "
            f"wall, device {busy:.1f} ms (a traced rerun); range "
            f"[{imgs.min().item():.2f}, {imgs.max().item():.2f}], "
            f"{'finite' if finite else 'NOT finite'}; the rerun under the "
            f"seed {'repeats it bit for bit' if same else 'differs'}; {card}")
        if not (finite and same):
            raise AssertionError(f"DDPM sample_ddim: finite {finite}, "
                                 f"repeated {same}")
        return {"DDPM sampling (EMA weights)": launch_counts()}


def falling(name, losses):
    """The means of the first and last 5 losses: finite and falling."""
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    ok = bool(np.isfinite(losses).all()) and last < first
    log(f"  {name}: loss {first:.4f} -> {last:.4f} (means of the first and "
        f"last 5 of {len(losses)}, {'falling' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{name}: loss not finite and falling")


def phase_examples(card):
    """Phase 15: the JAX package's examples on the port
    (lightgrad_tpu_torch/examples/), each through its own function on the
    card at the JAX script's configuration and step counts (EXAMPLE_CUTS
    lists the cuts): gradient descent; MNIST's MLP and CNN and ResNet-20 on
    synthetic digits (test accuracy at least DIGITS_ACCURACY); BERT's
    offline fallback config (the network refused) and its [MASK] top-k;
    the char GPT and the char LLaMA (f32 and --amp) on README.md, each
    then sampling; the T5 reversal; DDPM with its EMA sampler (then
    ``ddpm_checks``); the serving tour (speculative = greedy, the int8
    model's converted layers = TOUR_QUANT_LAYERS; its tp = 2 step skips on
    one process).  Each example's printed lines are logged, its losses
    must fall, and its launch counts are returned {path: (counts, the
    kernels it must launch)}.  examples/distributed.py needs 8 ranks: it
    runs on CPU ranks in the tests only."""
    import inspect
    import io

    from lightgrad_tpu_torch.examples import (bert, diffusion, gpt,
                                              gradient_descent, llama,
                                              mnist, resnet, serving, t5)
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    os.environ["LIGHTGRAD_FAKE_DATA"] = "1"
    steps = {}
    for k, fn in (("resnet", resnet.train), ("gpt", gpt.train_char_gpt),
                  ("llama", llama.train_char_llama), ("t5", t5.train),
                  ("diffusion", diffusion.main)):
        published = inspect.signature(fn).parameters["steps"].default
        steps[k] = EXAMPLE_CUTS.get(k, published)
        if steps[k] != published:
            log(f"  cut for time: {k} {published} -> {steps[k]} steps")
    paths = {}

    def run(path, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[path] = (launch_counts(), EXAMPLE_KERNELS[path])
        log(f"{path}: {wall:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
        return out

    out = run("gradient descent", gradient_descent.main)
    falling("gradient descent", out["losses"])
    for kind, path in (("mlp", "MNIST MLP"), ("cnn", "MNIST CNN")):
        out = run(path, lambda: mnist.main(kind))
        falling(path, out["losses"])
        digits_ok(path, out["accuracy"])
    out = run("ResNet-20", lambda: resnet.train(steps=steps["resnet"]))
    falling("ResNet-20", out["losses"])
    digits_ok("ResNet-20", out["accuracy"])
    # its checkpoint is not in the repository and the card has no network:
    # the fetch is refused before it leaves the host, and the example takes
    # its offline fallback
    with offline():
        out = run("BERT masked LM", bert.main)
    if not np.isfinite(out["row"]).all():
        raise AssertionError("BERT: the [MASK] row's logits are not finite")
    out = run("char GPT", lambda: gpt.train_char_gpt(steps=steps["gpt"]))
    falling("char GPT", out["losses"])
    if len(out["sample"]) != out["model"].cfg.n_positions:
        raise AssertionError(f"char GPT sampled {len(out['sample'])} chars")
    del out
    for amp, path in ((False, "char LLaMA"), (True, "char LLaMA (--amp)")):
        out = run(path, lambda: llama.train_char_llama(
            steps=steps["llama"], use_amp=amp))
        falling(path, out["losses"])
        if len(out["tokens"]) != len("lightgrad") + 120:
            raise AssertionError(f"{path}: {len(out['tokens'])} tokens")
    out = run("T5 reversal", lambda: t5.train(steps=steps["t5"]))
    falling("T5 reversal", out["losses"])
    out = run("DDPM", lambda: diffusion.main(steps=steps["diffusion"]))
    falling("DDPM", out["losses"])
    if not np.isfinite(out["images"]).all():
        raise AssertionError("DDPM: sampled images not finite")
    for path, counts in ddpm_checks(out, card).items():
        paths[path] = (counts, DDPM_SAMPLE_KERNELS)
    del out
    out = run("serving tour", lambda: serving.main("cuda"))
    if out["speculative"] != out["kv"]:
        raise AssertionError("serving tour: speculative != greedy")
    if out["n_quantized"] != TOUR_QUANT_LAYERS or \
            len(out["int8"]) != 8 + 16:
        raise AssertionError(f"serving tour: {out['n_quantized']} layers "
                             f"quantized, {len(out['int8'])} tokens")
    log(f"  serving tour: {out['kv_tok_per_s']:.1f} tok/s single-stream, "
        f"{out['batch_tok_per_s']:.1f} tok/s batched x4; "
        f"{out['n_quantized']} Linears quantized (the JAX tour's "
        f"{TOUR_QUANT_LAYERS}); {card}")
    log("examples/distributed.py: not run here (torchrun over 8 GPUs, or "
        "--device cpu: 8 gloo CPU ranks; one card here), held by "
        "tests/test_torch_examples_dist.py")
    torch.cuda.empty_cache()
    return paths


# phase 16: the step compiler -- compiled steps against eager steps from one
# starting state (JIT_STEPS each), the dropout case's replays, the AMP
# overflow step (the step index given an infinite loss factor)
JIT_STEPS = 6
JIT_OVERFLOW_AT = 3
JIT_DROPOUT = 0.1


def _snapshot(model):
    """Every parameter and buffer of a tape module as numpy (a copy)."""
    return {n: np.array(t) for n, t in model.state_dict().items()}


def _timed_calls(fn, args, n):
    """``n`` calls of ``fn(*args)``, each ended by a device sync: (outputs,
    wall seconds of each)."""
    outs, walls = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        # a kept eager loss would keep its step's tape (and activations)
        outs.append(tuple(o.detach() for o in out) if isinstance(out, tuple)
                    else out.detach())
    return outs, walls


def _device_time(call):
    """One ``call()`` traced by torch.profiler: (device ms summed over its
    kernels, wall ms) -- and, since a graph replay may reach the trace as
    one launch, the device ms between two CUDA events around it."""
    _, busy, wall = traced_families(call)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    call()
    end.record()
    end.synchronize()
    return busy, wall, start.elapsed_time(end)


def jit_case(name, model, make_step, args, card, state=None, same=True):
    """Phase 16's comparison: ``make_step()`` -> a step function over a
    fresh optimizer; JIT_STEPS eager steps, then the weights carried back
    (``load_numpy_params``) and JIT_STEPS compiled steps from the same
    start.  ``same``: losses and every parameter and buffer bit for bit.
    Logs wall ms a step (eager, compiled), device ms and idle share
    (torch.profiler, one step of each after the comparison), the capture's
    seconds, both peaks and the launches of a replay.  Returns (the
    compiled run's launch counts, {metric: value})."""
    from lightgrad_tpu_torch import jit, load_numpy_params
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    start = _snapshot(model)
    out = {}
    runs = []
    for compiled in (False, True):
        if compiled:
            load_numpy_params(model, start)
        step = make_step()
        fn = jit(step) if compiled else step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        res, walls = _timed_calls(fn, args, JIT_STEPS)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        losses = [float((r[0] if isinstance(r, tuple) else r).numpy())
                  for r in res]
        runs.append((losses, _snapshot(model), state() if state else None))
        reset_launch_counts()
        busy, wall, ev = _device_time(lambda: fn(*args))
        per_call = {k: v for k, v in launch_counts().items() if v}
        key = "compiled" if compiled else "eager"
        out[key] = dict(wall_ms=1e3 * float(np.median(walls[2:])),
                        device_ms=busy, traced_wall_ms=wall, event_ms=ev,
                        idle=1 - busy / wall if wall else None,
                        peak_gib=peak / 2**30, first_ms=1e3 * walls[0])
        if compiled:
            out[key]["capture_s"] = walls[1] - float(np.median(walls[2:]))
            out[key]["launches_a_replay"] = per_call
            run_counts = counts
        log(f"  {name}, {key}: {out[key]['wall_ms']:.2f} ms a step (median "
            f"of steps 3-{JIT_STEPS}; step 1 {out[key]['first_ms']:.0f} ms"
            + (f", step 2 with the capture {1e3 * walls[1]:.0f} ms: capture "
               f"{out[key]['capture_s']:.2f} s" if compiled else "")
            + f"); device {busy:.2f} ms of a {wall:.2f} ms traced step (idle "
            f"{100 * out[key]['idle']:.1f}%), {ev:.2f} ms between events; "
            f"peak {out[key]['peak_gib']:.2f} GiB above the model; {card}")
        del res, fn, step
    log(f"  {name}: launches a replay {out['compiled']['launches_a_replay']}")
    (le, pe, se), (lc, pc, sc) = runs
    worst = max(float(np.abs(pe[n] - pc[n]).max()) for n in pe)
    bitwise = le == lc and worst == 0.0 and se == sc
    log(f"  {name}: losses eager {[round(v, 5) for v in le]}, compiled "
        f"{[round(v, 5) for v in lc]}; parameters and buffers "
        f"{'bit for bit' if bitwise else f'max abs diff {worst:.3e}'}"
        + (f"; state {se} / {sc}" if state else ""))
    if same and not bitwise:
        raise AssertionError(f"{name}: the compiled steps are not the eager "
                             f"steps bit for bit")
    return run_counts, out


def jit_amp_case(model, start, args, x_mask, lm_loss, card):
    """Phase 16's AMP case: BERT-base under bf16 ``MixedPrecision`` (AdamW,
    a GradScaler growing every 2 good steps), JIT_STEPS eager steps and
    JIT_STEPS compiled ones from the same f32 start, the loss times an
    infinite factor (a tensor argument) at step JIT_OVERFLOW_AT: the gate
    skips that step and the scale backs off, inside the graph.  Losses,
    scales and masters bit for bit.  Returns (launch counts of the
    compiled run, {metric: value})."""
    from lightgrad_tpu_torch import amp, jit, load_numpy_params, optim
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    factors = [Tensor.from_numpy(np.float32(np.inf if i == JIT_OVERFLOW_AT
                                            else 1.0), requires_grad=False)
               for i in range(JIT_STEPS)]
    runs, out = [], {}
    for compiled in (False, True):
        amp.cast_module(model, torch.float32)
        load_numpy_params(model, start)
        mp = amp.MixedPrecision(model, lambda ps: optim.AdamW(
            ps, lr=BERT_LR), scaler=amp.GradScaler(init_scale=2.0 ** 15,
                                                   growth_interval=2))

        def step(a, b, k):
            loss = lm_loss(model(a, attention_mask=x_mask), b)
            mp.zero_grad()
            mp.scale(loss * k).backward()
            mp.step()
            return loss

        fn = jit(step) if compiled else step
        torch.cuda.synchronize()
        reset_launch_counts()
        losses, scales, walls = [], [], []
        for k in factors:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = fn(*args, k)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss.numpy()))
            scales.append(mp.scaler.scale_value())
        counts = launch_counts()
        runs.append((losses, scales, [m.numpy() for m in mp.masters]))
        key = "compiled" if compiled else "eager"
        out[key] = dict(wall_ms=1e3 * float(np.median(walls[2:])))
        log(f"  BERT-base bf16 MixedPrecision, {key}: losses "
            f"{[round(v, 4) for v in losses]}, scales {scales}, "
            f"{out[key]['wall_ms']:.2f} ms a step; {card}")
        del fn, step, mp, loss
    (le, se, me), (lc, sc, mc) = runs
    backed = se[JIT_OVERFLOW_AT] == se[JIT_OVERFLOW_AT - 1] / 2
    if not backed or se != sc or le != lc or not all(
            np.array_equal(a, b) for a, b in zip(me, mc)):
        raise AssertionError("BERT-base AMP: the compiled steps are not the "
                             "eager steps bit for bit, or the overflow did "
                             "not back the scale off")
    log(f"  BERT-base AMP: the overflow at step {JIT_OVERFLOW_AT + 1} "
        f"skipped and the scale backed off inside the graph; losses, scales "
        f"and masters bit for bit the eager steps'")
    return counts, out


def phase_step_compiler(card):
    """Phase 16: ``lightgrad_tpu_torch.jit`` at full width -- each case
    JIT_STEPS compiled steps against JIT_STEPS eager steps from one start,
    bit for bit: BERT-base (phase 6's masked LM, 8 x 128, f32 AdamW) with
    its padding mask and with ``attention_lengths``; ResNet-18 f32 at 32 x
    224² (BatchNorm's buffers written back); BERT-base under bf16
    ``MixedPrecision`` with an infinite loss factor at step
    JIT_OVERFLOW_AT (the gate skips it and the scale backs off inside the
    graph); BERT-base with dropout on its logits (two replays draw other
    masks, keep rate within 1% of 1 - JIT_DROPOUT); the guards: a
    ``load_numpy_params`` after compiling records again and trains the
    loaded weights, a parameter rebound between the record and the compile
    makes the step record again and trains, and a step with a host read
    inside raises ``CaptureError``.  (Pythia-1B's compiled recompute decode against its
    eager tokens runs in phase 10b, on that phase's model.)  Returns
    {path: launch counts of its compiled run}."""
    import importlib

    from lightgrad_tpu_torch import jit, load_numpy_params, optim
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import random as lg_random
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.models import resnet18
    from lightgrad_tpu_torch.models.bert import BertConfig, BertForMaskedLM

    jit_mod = importlib.import_module("lightgrad_tpu_torch.jit")
    dev = torch.device("cuda")
    counts = {}
    metrics = {}
    lg_random.seed(0)
    cfg = BertConfig(**BERT_BASE)
    model = BertForMaskedLM(cfg)
    ids, mask, labels, lengths = bert_batch(cfg)
    x_ids = Tensor.from_numpy(ids, requires_grad=False)
    x_mask = Tensor.from_numpy(mask, requires_grad=False)
    x_lens = Tensor.from_numpy(lengths.astype(np.int32), requires_grad=False)
    y = Tensor.from_numpy(labels, requires_grad=False)

    def lm_loss(logits, yy):
        return lg_loss.cross_entropy(logits.reshape(-1, cfg.vocab_size), yy,
                                     ignore_index=-100)

    def bert_step(**inputs):
        def make():
            opt = optim.AdamW(list(model.parameters()), lr=BERT_LR)

            def step(a, b):
                loss = lm_loss(model(a, **inputs), b)
                opt.zero_grad()
                loss.backward()
                opt.step()
                return loss
            return step
        return make

    for path, inputs in (("BERT-base (masked)", dict(attention_mask=x_mask)),
                         ("BERT-base (attention_lengths)",
                          dict(attention_lengths=x_lens))):
        counts[path], metrics[path] = jit_case(
            path, model, bert_step(**inputs), (x_ids, y), card)

    # the guards: a load after compiling records again and trains the
    # loaded weights, as the eager steps from them did
    start = _snapshot(model)
    eager = []
    make = bert_step(attention_mask=x_mask)
    step = make()
    for _ in range(2):
        eager.append(float(step(x_ids, y).numpy()))
    load_numpy_params(model, start)
    holder = [make()]
    fn = jit(lambda a, b: holder[0](a, b))
    for _ in range(3):
        fn(x_ids, y)
    state = next(iter(fn.cache.values()))
    load_numpy_params(model, start)
    holder[0] = make()
    if not fn._stale(state):
        raise AssertionError("a load after compiling left the graph "
                             "current")
    again = [float(fn(x_ids, y).numpy()) for _ in range(2)]
    if fn.cache[fn._signature((x_ids, y))] is state or again != eager:
        raise AssertionError(f"a load after compiling: recorded again "
                             f"{fn.cache.get(fn._signature((x_ids, y))) is not state}"
                             f", losses {again} vs eager {eager}")
    log(f"  guard: load_numpy_params after compiling recorded again; the "
        f"next losses {again} are the eager steps' from those weights")
    del fn, holder, state

    # a parameter rebound between the record and the compile of one
    # compiled step: the epoch makes call 2 record again (a graph over the
    # recorded sets would drop the new bias's update), and the new bias
    # trains as in the eager steps
    def new_bias():
        return Tensor.from_numpy(np.full(cfg.vocab_size, 0.01, np.float32))

    load_numpy_params(model, start)
    step = make()
    eager = [float(step(x_ids, y).numpy())]
    model.decoder.bias = new_bias()
    step = make()
    eager += [float(step(x_ids, y).numpy()) for _ in range(2)]
    eager_bias = model.decoder.bias.numpy()
    load_numpy_params(model, start)
    holder = [make()]
    fn = jit(lambda a, b: holder[0](a, b))
    again = [float(fn(x_ids, y).numpy())]
    model.decoder.bias = new_bias()
    holder[0] = make()
    again += [float(fn(x_ids, y).numpy()) for _ in range(2)]
    if again != eager or not (model.decoder.bias.numpy() == eager_bias).all():
        raise AssertionError(f"a rebind between record and compile: losses "
                             f"{again} vs eager {eager}")
    log(f"  guard: a parameter rebound after the record recorded again; "
        f"losses {again} and the new bias are the eager steps'")
    del fn, holder

    def synced(a, b):
        loss = lm_loss(model(a, attention_mask=x_mask), b)
        return loss * float(loss.data.sum())       # a host read: refused

    bad = jit(synced)
    bad(x_ids, y)
    try:
        bad(x_ids, y)
    except jit_mod.CaptureError as e:
        log(f"  guard: a host read inside the step raised CaptureError: "
            f"{str(e)[:160]}...")
    else:
        raise AssertionError("a step with a host read was captured")
    del bad

    # dropout on the logits: two replays draw other masks
    drop_opt = optim.AdamW(list(model.parameters()), lr=BERT_LR)

    def drop_step(a, b):
        logits = model(a, attention_mask=x_mask).dropout(p=JIT_DROPOUT)
        loss = lm_loss(logits, b)
        drop_opt.zero_grad()
        loss.backward()
        drop_opt.step()
        return loss, logits

    fn = jit(drop_step)
    keeps = [(fn(x_ids, y)[1].data != 0) for _ in range(3)]
    rates = [float(k.float().mean()) for k in keeps]
    same_mask = bool(torch.equal(keeps[1], keeps[2]))
    log(f"  dropout {JIT_DROPOUT} on BERT-base's logits: keep rates "
        f"{[round(r, 4) for r in rates]} (record, capture + replay, replay);"
        f" the two replays' masks {'EQUAL' if same_mask else 'differ'}")
    if same_mask or any(abs(r - (1 - JIT_DROPOUT)) > 0.01 for r in rates):
        raise AssertionError("dropout inside the graph: masks repeat or "
                             "the keep rate is off")
    del fn, keeps, drop_opt
    torch.cuda.empty_cache()

    # bf16 MixedPrecision with a forced overflow
    counts["BERT-base AMP (bf16, overflow)"], metrics["BERT-base AMP"] = \
        jit_amp_case(model, start, (x_ids, y), x_mask, lm_loss, card)
    del model
    torch.cuda.empty_cache()

    # ResNet-18, f32, BatchNorm buffers written back
    lg_random.seed(0)
    rmodel = resnet18()
    gen = torch.Generator(device=dev).manual_seed(12)
    xd = torch.randn(RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE,
                     generator=gen, device=dev)
    yd = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen, device=dev)
    rx = Tensor(xd, requires_grad=False)
    ry = Tensor(yd.int(), requires_grad=False)

    def resnet_make():
        opt = optim.AdamW(list(rmodel.parameters()), lr=RESNET_LR)

        def step(a, b):
            loss = lg_loss.cross_entropy(rmodel(a), b)
            opt.zero_grad()
            loss.backward()
            opt.step()
            return loss
        return step

    counts["ResNet-18"], metrics["ResNet-18"] = jit_case(
        "ResNet-18", rmodel, resnet_make, (rx, ry), card)
    del rmodel
    torch.cuda.empty_cache()
    log(f"  phase 16 metrics: {json.dumps(metrics)}")
    return counts


@contextlib.contextmanager
def offline():
    """``urllib.request.urlopen`` refused inside the block."""
    import urllib.request

    def refuse(*args, **kwargs):
        raise OSError("no network on this run")

    saved, urllib.request.urlopen = urllib.request.urlopen, refuse
    try:
        yield
    finally:
        urllib.request.urlopen = saved


def digits_ok(path, acc):
    if acc < DIGITS_ACCURACY:
        raise AssertionError(f"{path}: test accuracy {acc:.4f} < "
                             f"{DIGITS_ACCURACY}")


# the kernels each compiled path launches (its replays' counts)
COMPILED_PATHS = {"float32 engine": ("attention_fwd", "decode_stack_batch"),
                  "bfloat16 engine": ("attention_fwd", "decode_stack_batch"),
                  "int8 engine": ("attention_fwd",
                                  "decode_stack_batch_int8_kvq"),
                  "float32 generate_device": ("attention_fwd",
                                              "decode_stack"),
                  "bfloat16 generate_device": ("attention_fwd",
                                               "decode_stack"),
                  "int8 generate_device": ("attention_fwd",
                                           "decode_stack_int8_kvq"),
                  "generate_batch_device": ("attention_fwd",),
                  "Mistral-7B engine": ("attention_fwd",
                                        "decode_attention_batch"),
                  "Mistral-7B generate_device": ("attention_fwd",
                                                 "decode_attention")}
# phase 17, compiled decoding: generate_device / generate_batch_device tokens
# and prompts at GPT-2 small; Mistral-7B's 4-slot engine (prompts, new tokens
# each) and generate_device tokens after its 4500-token prompt; T5-base's
# generate_compiled tokens after a 64-token source
COMPILED_NEW, COMPILED_BATCH = 32, (12, 40, 5, 27)
MISTRAL_COMPILED_ENGINE, MISTRAL_COMPILED_NEW = (600, 32, 1800, 250), 48
T5_COMPILED_SRC, T5_COMPILED_NEW = 64, 32


def paramfns(fns, *extra):
    """The compiled functions a model's decoding reached: its KVFns' and
    the loops' kept ones (``KVFns.functions``), and ``extra``."""
    return fns.functions() + list(extra)


def engine_fns(engine):
    """An engine's own compiled functions: its admission, its mixed
    tick's ``step_batch`` and its ticks."""
    return [engine._admit, engine._step_batch, *engine._tick_fns.values()]


def graph_report(pfs):
    """(graphs captured, capture seconds, nodes of the largest graph, the
    nodes and counted launches a replay of each distinct graph) over
    ParamFns' compiled signatures."""
    gs = [g for pf in pfs for g in pf.graphs()]
    if not gs:
        raise AssertionError("no compiled signature: nothing was captured")
    big = max(gs, key=lambda g: g["nodes"] or 0)
    per_replay = sorted({f"{g['nodes']} nodes: " + (", ".join(
        f"{k} {n}" for k, n in sorted(g["launches"].items())) or "none")
        for g in gs})
    return (len(gs), sum(g["capture_s"] for g in gs), big["nodes"],
            "; ".join(per_replay))


def compiled_vs_eager(name, run, unit, pfs, card, base=None, warm=2):
    """``run()`` eagerly (every ParamFn through its ``.fn``), timed and
    traced, then compiled: ``warm`` runs that record and capture (an
    engine, which one path reuses, captures all in its first), then a timed
    replay run (its launches counted) and a traced one.  ``run`` returns (tokens,
    units).  With ``base`` (a shorter run of the same prefills) its times
    and units are taken off, so the prefills cancel.  Each peak is of its
    own runs (the eager one before any graph).  Fails unless every run
    gives the same tokens; logs wall and device ms a unit, the idle share,
    the graphs' capture seconds, nodes and launches a replay, the peaks,
    and the seconds the path took.  Returns the timed compiled run's
    launch counts."""
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    t_path = time.perf_counter()

    def timed_run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def measured():
        """(tokens, units, wall ms, device ms, launch counts) of ``run``
        less ``base``'s, and the peak memory of these runs."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        (toks, units), wall = timed_run(run)
        counts = launch_counts()
        (again, _), dev = traced_kernel_ms(run)
        if again != toks:
            raise AssertionError(f"{name}: a traced run's tokens differ")
        if base is not None:
            (_, b_units), b_wall = timed_run(base)
            _, b_dev = traced_kernel_ms(base)
            units, wall, dev = units - b_units, wall - b_wall, dev - b_dev
        return toks, units, wall, dev, counts, \
            torch.cuda.max_memory_allocated()

    with eager_decoding():
        t_e, _, wall_e, dev_e, _, peak_e = measured()
    warmed = [run()[0] for _ in range(warm)]
    if base is not None:
        for _ in range(warm):
            base()
    toks, units, wall_c, dev_c, counts, peak_c = measured()
    n_graphs, cap_s, nodes, per_replay = graph_report(pfs())
    if any(w != toks for w in warmed) or t_e != toks:
        raise AssertionError(f"{name}: the compiled runs' tokens differ "
                             f"from each other or from the eager run's")
    log(f"  {name}: compiled {wall_c / units:.3f} wall ms a {unit}, "
        f"{dev_c / units:.3f} device ms (idle "
        f"{100 * (1 - dev_c / wall_c):.1f}%), peak "
        f"{peak_c / 2**30:.2f} GiB, {n_graphs} graphs captured in "
        f"{cap_s:.2f} s, the largest {nodes} nodes, counted launches a "
        f"replay by graph ({per_replay}); eager {wall_e / units:.3f} wall "
        f"ms, {dev_e / units:.3f} device ms (idle "
        f"{100 * (1 - dev_e / wall_e):.1f}%), peak {peak_e / 2**30:.2f} "
        f"GiB; {units} {unit}s{' beyond the prefills' if base else ''}, "
        f"the same tokens; {time.perf_counter() - t_path:.1f} s; {card}")
    return counts


def replay_check(name, dtype, kernel, plain, args, tol):
    """``kernel(*args)`` compiled by a ParamFn (record, capture, replay):
    the replay's outputs held against ``plain(*args)`` at ``tol``.
    Returns the largest error."""
    from lightgrad_tpu_torch.models.decoding import ParamFn

    pf = ParamFn(lambda p, *a: kernel(*a), {}, by_address=())
    for _ in range(3):
        got = pf(*args)
    if pf.captures != 1 or pf.graphs()[0]["nodes"] == 0:
        raise AssertionError(f"{name}: no graph was captured")
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(check(f"{name} in a replay", dtype, g, w, tol)
               for g, w in zip(got, want))


def replayed_kernels(gpt, mistral):
    """Each kernel of the compiled decode paths inside a replay against its
    plain version, at the paths' shapes: the flash forward (a GPT-2 small
    prefill; Mistral-7B's, grouped and banded at W 8192), decode attention
    and its batched form
    (Mistral-7B's grouped heads over W 8192), the stack kernel and its
    batched form over GPT-2 small's packed weights, float and int8."""
    from lightgrad_tpu_torch.models.gpt import quantize_rows
    from lightgrad_tpu_torch.ops.attention import (attention_fwd,
                                                   attention_fwd_reference)
    from lightgrad_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_batch,
        decode_attention_batch_reference, decode_attention_reference)
    from lightgrad_tpu_torch.ops.decode_stack import (
        decode_stack, decode_stack_batch, decode_stack_batch_reference,
        decode_stack_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    cfg = gpt.cfg
    L, H, W, d = cfg.n_layer, cfg.n_head, cfg.n_positions, cfg.n_embd
    hd, eps = d // H, cfg.layer_norm_epsilon
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (rnd(H, W, hd, dtype=dtype) for _ in range(3))
        replay_check("attention_fwd (GPT-2 small prefill)", dtype,
                     lambda *a: attention_fwd(*a, hd ** -0.5, causal=True),
                     lambda *a: attention_fwd_reference(
                         *a, hd ** -0.5, causal=True), (q, k, v),
                     FWD_TOL[dtype])
    mc = mistral.cfg
    KV, G, mhd = mc.num_key_value_heads, \
        mc.num_attention_heads // mc.num_key_value_heads, mc.head_dim
    MW, band = mc.max_position_embeddings, mc.sliding_window
    bf = torch.bfloat16
    mq = rnd(KV * G, MW, mhd, dtype=bf)
    kc, vc = (rnd(KV, MW, mhd, dtype=bf) for _ in range(2))
    replay_check("attention_fwd (Mistral-7B prefill, banded)", bf,
                 lambda *a: attention_fwd(*a, mhd ** -0.5, causal=True,
                                          window=band),
                 lambda *a: attention_fwd_reference(
                     *a, mhd ** -0.5, causal=True, window=band),
                 (mq, kc, vc), FWD_TOL[bf])
    del mq
    torch.cuda.empty_cache()
    replay_check("decode_attention (Mistral-7B, pos 4500)", bf,
                 lambda q1, kc, vc, pos: decode_attention(
                     q1, kc, vc, pos, mhd ** -0.5, window=band),
                 lambda q1, kc, vc, pos: decode_attention_reference(
                     q1, kc, vc, pos, mhd ** -0.5, band),
                 (rnd(KV, G, mhd, dtype=bf), kc, vc, 4500), KERNEL_TOL[bf])
    kb, vb = (rnd(4, KV, MW, mhd, dtype=bf) for _ in range(2))
    poss = torch.tensor([4600, 33, 1801, 251], dtype=torch.int32, device=dev)
    replay_check("decode_attention_batch (Mistral-7B engine, 4 slots)", bf,
                 lambda *a: decode_attention_batch(*a, mhd ** -0.5,
                                                   window=band),
                 lambda *a: decode_attention_batch_reference(
                     *a, mhd ** -0.5, band),
                 (rnd(4, KV, G, mhd, dtype=bf), kb, vb, poss), KERNEL_TOL[bf])
    del kc, vc, kb, vb
    fns = gpt._kv_functions()
    p = fns.step.params
    slabs, vecs = p["stack#slabs"], p["stack#vecs"]
    cache = rnd(L, 2, H, W, hd)
    cache8, kvs8 = quantize_rows(cache)
    caches = rnd(8, L, 2, H, W, hd)
    caches8, bkvs8 = quantize_rows(caches)
    gpt.quantize_serving()
    qp = gpt._kv_functions().step.params
    slabs8, scales8 = qp["stack#slabs"], qp["stack#scales"]
    gpt.quantize_serving(False)
    bposs = torch.tensor([46, 26, 33, 14, 14, 20, 30, 9], dtype=torch.int32,
                         device=dev)
    tol = KERNEL_TOL[torch.float32]
    for sfx, sl, scl, c, kvs, cs, bkvs in (
            ("", slabs, None, cache, None, caches, None),
            ("_int8", slabs8, scales8, cache, None, caches, None),
            ("_kvq", slabs, None, cache8, kvs8, caches8, bkvs8),
            ("_int8_kvq", slabs8, scales8, cache8, kvs8, caches8, bkvs8)):
        replay_check(f"decode_stack{sfx} (GPT-2 small step at 37)",
                     torch.float32,
                     lambda x, c, pos: decode_stack(
                         x, c, pos, sl, vecs, scl, eps=eps, kv_scales=kvs),
                     lambda x, c, pos: decode_stack_reference(
                         x, c, pos, sl, vecs, scl, eps=eps, kv_scales=kvs),
                     (rnd(1, d), c, 37), tol)
        replay_check(f"decode_stack_batch{sfx} (GPT-2 small engine tick)",
                     torch.float32,
                     lambda x, cs, ps: decode_stack_batch(
                         x, cs, ps, sl, vecs, scl, eps=eps, kv_scales=bkvs),
                     lambda x, cs, ps: decode_stack_batch_reference(
                         x, cs, ps, sl, vecs, scl, eps=eps, kv_scales=bkvs),
                     (rnd(8, d), cs, bposs), tol)
    del cache, cache8, caches, caches8, fns, p
    torch.cuda.empty_cache()


def engine_run(engine, reqs):
    """``reqs`` through ``engine`` (one engine serves every run of a path,
    as a server's does, so its compiled ticks replay from run to run)
    under sync debug mode "error": (each request's tokens, the ticks this
    run took)."""
    ticks = engine.stats["step_dispatches"]
    handles = [engine.submit(p, n) for p, n in reqs]
    sync_free(engine.run)
    return [h.tokens for h in handles], \
        engine.stats["step_dispatches"] - ticks


def phase_compiled_decoding(card):
    """Phase 17: the compiled decode paths at full width against the same
    calls with every ParamFn through its ``.fn`` (:func:`compiled_vs_eager`):
    GPT-2 small f32, bf16 and int8 (quantize_serving + quantize_kv over
    f32) through the engine over bench.py's 32 ragged requests at
    steps_per_tick 1 and 8, ``generate_device`` greedy and sampled and
    ``generate_batch_device``; Mistral-7B bf16 at 16 of 32 layers (W 8192):
    the 4-slot engine and ``generate_device``; T5-base's
    ``generate_compiled``.  Then each kernel of these paths inside a replay
    (:func:`replayed_kernels`).  Returns {path: launch counts}."""
    from lightgrad_tpu_torch import GPT, GPTConfig, InferenceEngine
    from lightgrad_tpu_torch.models.decoding import _kv

    dev = torch.device("cuda")
    paths = {}
    gpt = GPT(GPTConfig(**GPT2_SMALL), device=dev,
              generator=torch.Generator(device=dev).manual_seed(0))
    V = gpt.cfg.vocab_size
    reqs = serving_requests(V)
    rng = np.random.default_rng(21)
    prompt = [int(t) for t in rng.integers(0, V, 12)]
    prompts = [[int(t) for t in rng.integers(0, V, n)]
               for n in COMPILED_BATCH]
    for mode in ("float32", "bfloat16", "int8"):
        if mode == "bfloat16":
            gpt.to(torch.bfloat16)
        if mode == "int8":
            gpt.to(torch.float32)
            gpt.quantize_serving().quantize_kv()
        gpt.generate(prompt, max_new_tokens=2)      # packs, warms cuBLAS
        fns = _kv(gpt)
        for steps in (1, 8):
            engine = InferenceEngine(gpt, slots=8, steps_per_tick=steps)
            paths[f"GPT-2 small {mode} engine, steps_per_tick {steps}, "
                  f"compiled"] = compiled_vs_eager(
                f"GPT-2 small {mode} engine, 32 requests, steps_per_tick "
                f"{steps}", lambda e=engine: engine_run(e, reqs), "tick",
                lambda e=engine: paramfns(fns, *engine_fns(e)), card,
                warm=1)
            del engine
        paths[f"GPT-2 small {mode} generate_device, compiled"] = \
            compiled_vs_eager(
                f"GPT-2 small {mode} generate_device, {COMPILED_NEW} greedy "
                f"tokens", lambda: (gpt.generate_device(
                    prompt, COMPILED_NEW), COMPILED_NEW), "token",
                lambda: paramfns(fns), card)
        compiled_vs_eager(
            f"GPT-2 small {mode} generate_device, {COMPILED_NEW} sampled "
            f"tokens at seed 5", lambda: (gpt.generate_device(
                prompt, COMPILED_NEW, seed=5, **SAMPLED), COMPILED_NEW),
            "token", lambda: paramfns(fns), card)
        paths[f"GPT-2 small {mode} generate_batch_device, compiled"] = \
            compiled_vs_eager(
                f"GPT-2 small {mode} generate_batch_device, prompts "
                f"{list(COMPILED_BATCH)}, {COMPILED_NEW} tokens each",
                lambda: (gpt.generate_batch_device(prompts, COMPILED_NEW),
                         COMPILED_NEW), "round", lambda: paramfns(fns), card)
    gpt.quantize_serving(False).quantize_kv(False)
    torch.cuda.empty_cache()

    mistral = llama_model(MISTRAL_7B, torch.bfloat16,
                          num_hidden_layers=MISTRAL_SERVING_LAYERS)
    MV = mistral.cfg.vocab_size
    mprompt = [int(t) for t in rng.integers(0, MV, 4500)]
    mprompts = [[int(t) for t in rng.integers(0, MV, n)]
                for n in MISTRAL_COMPILED_ENGINE]
    mistral.generate(mprompt[:8], max_new_tokens=2)
    mfns = _kv(mistral)
    engine = InferenceEngine(mistral, slots=4)
    paths["Mistral-7B engine, compiled"] = compiled_vs_eager(
        f"Mistral-7B bf16 ({MISTRAL_SERVING_LAYERS} layers, W 8192) engine, "
        f"4 slots, prompts {list(MISTRAL_COMPILED_ENGINE)}, "
        f"{MISTRAL_COMPILED_NEW} tokens each (its prefill graph at W 8192)",
        lambda: engine_run(engine, [(p, MISTRAL_COMPILED_NEW)
                                    for p in mprompts]), "tick",
        lambda: paramfns(mfns, *engine_fns(engine)), card,
        base=lambda: engine_run(engine, [(p, 1) for p in mprompts]), warm=1)
    del engine
    paths["Mistral-7B generate_device, compiled"] = compiled_vs_eager(
        f"Mistral-7B bf16 generate_device, {MISTRAL_COMPILED_NEW} greedy "
        f"tokens after 4500", lambda: (mistral.generate_device(
            mprompt, MISTRAL_COMPILED_NEW), MISTRAL_COMPILED_NEW), "token",
        lambda: paramfns(mfns), card, base=lambda: (
            mistral.generate_device(mprompt, 1), 1))

    t5 = t5_model(T5_BASE)
    src = rng.integers(2, T5_BASE["vocab_size"], T5_COMPILED_SRC) \
        .astype(np.int32)

    def t5_run():
        out = t5.generate_compiled(src, max_new_tokens=T5_COMPILED_NEW)
        return [int(t) for t in out], len(out)

    compiled_vs_eager(
        f"T5-base generate_compiled, {T5_COMPILED_NEW} tokens after "
        f"{T5_COMPILED_SRC}", t5_run, "token",
        lambda: list(t5._compiled_functions(T5_COMPILED_NEW + 1)[0]), card)
    del t5
    replayed_kernels(gpt, mistral)
    del gpt, mistral, mfns, fns
    torch.cuda.empty_cache()
    return paths


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from lightgrad_tpu_torch import GPT, GPTConfig
    from lightgrad_tpu_torch.ops import KERNELS, _build

    # the run's clock: each stretch of phases logs its seconds (the run's
    # time budget is spent by these lines)
    run_t0 = last = time.perf_counter()

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        log(f"[clock] {what}: {now - last:.1f} s (the run at "
            f"{now - run_t0:.1f} s)")
        last = now

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library()
    grids = {f"{t}{'/w8' * w}{'/kv8' * k}": lib.lg_decode_stack_grid(
        t == "bf16", w, k) for t in ("f32", "bf16") for w in (0, 1)
        for k in (0, 1)}
    slots = ctypes.c_int()
    smem = {}
    for t, wb in (("f32", 4), ("bf16", 2), ("w8", 1)):
        nbytes = lib.lg_decode_stack_smem(8, GPT2_SMALL["n_embd"], 4, wb,
                                          ctypes.byref(slots))
        smem[t] = f"{nbytes} B, {slots.value} slots"
    log(f"build: nvcc {_build.build_seconds():.1f} s, loaded in "
        f"{time.perf_counter() - t0:.1f} s; stack kernel grids (blocks) "
        f"{grids}; dynamic shared memory at n 8, d 768 by weight type "
        f"{smem}")
    if not all(grids.values()):
        raise AssertionError(f"a stack kernel instantiation was refused: "
                             f"{grids}")

    dev = torch.device("cuda")
    model = GPT(GPTConfig(**GPT2_SMALL), device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    # the speculative draft: the target's embeddings, first DRAFT_LAYERS
    # blocks and final LayerNorm (a truncated target, so it agrees often)
    draft = GPT(GPTConfig(**dict(GPT2_SMALL, n_layer=DRAFT_LAYERS)),
                device=dev)
    draft.load_state_dict({n: t for n, t in model.state_dict().items()
                           if n in draft.state_dict()})

    lap("device and build")

    # 3. kernels vs plain versions
    results = {}
    log("kernels vs plain versions:")
    phase_kernels(model, results)
    phase_train_kernels(results)
    phase_flash_kernels(results)
    phase_tape_kernels(results)
    phase_conv_kernels(results)
    t0 = time.perf_counter()
    phase_llama_kernels(results)
    log(f"  LLaMA-family kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_neox_kernels(results)
    log(f"  fused backward at Pythia's head dims: "
        f"{time.perf_counter() - t0:.1f} s")
    lap("kernels vs plain versions")

    # 4.-9. each path, with the kernels it launched
    launches = dict.fromkeys(KERNELS, 0)
    # the matmul kernel's operand loaders, counted a path (the element
    # loader serves operands whose rows cannot feed 16-byte copies)
    loaders = importlib.import_module(
        "lightgrad_tpu_torch.ops.matmul").loader_counts
    loaders.update(dict.fromkeys(loaders, 0))

    def tally(path, counts, path_kernels):
        log(f"  launches: {counts}")
        if any(loaders.values()):
            log(f"  matmul operand loaders: {dict(loaders)}")
            loaders.update(dict.fromkeys(loaders, 0))
        missing = [k for k in path_kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
        if counts.get("elementwise_copy"):
            raise AssertionError(f"the {path} path copied "
                                 f"{counts['elementwise_copy']} elementwise "
                                 f"operands: a view the kernel cannot read")
        for k in KERNELS:
            launches[k] += counts[k]

    def tally_decoding(tag, paths, sfx):
        for path, counts in paths.items():
            tally(f"{path}, {tag}", counts,
                  ("attention_fwd", DEVICE_PATHS[path] + sfx))

    for dtype in (torch.float32, torch.bfloat16):
        if dtype != torch.float32:
            model.to(dtype)
            draft.to(dtype)
        log(f"serving path, GPT-2 small, {str(dtype)[6:]}:")
        tally(f"serving ({dtype})", phase_main_path(model, dtype),
              SERVING_KERNELS)
        t0 = time.perf_counter()
        tally_decoding(str(dtype), drive_device_decoding(
            model, draft, dtype, str(dtype)), "")
        log(f"  decoding module: {time.perf_counter() - t0:.1f} s")
        for mode, (counts, paths) in phase_int8_serving(
                model, draft, dtype).items():
            sfx = INT8_MODES[mode]
            tally(f"int8 serving, {mode} ({dtype})", counts,
                  ("decode_stack" + sfx, "decode_stack_batch" + sfx))
            tally_decoding(f"{mode} ({dtype})", paths, sfx)
    log("long context, GPT-2 small, bfloat16:")
    phase_long_context(model, card)
    lap("GPT-2 serving")
    del model, draft
    torch.cuda.empty_cache()
    rates = {}
    for dtype, what, fused in (
            (torch.float32, "float32, Adam", False),
            (torch.float32, "float32, Adam, fused flash backward", True),
            (torch.bfloat16, "bfloat16 MixedPrecision, AdamW", False),
            (torch.bfloat16, "bfloat16 MixedPrecision, AdamW, fused flash "
             "backward", True)):
        log(f"training path, GPT-2 small, {what}:")
        counts, *rates[what] = phase_train(dtype, card, fused)
        tally(f"training ({what})", counts,
              FUSED_KERNELS if fused else TRAINING_KERNELS)
        if fused and (counts["attention_bwd_dq"]
                      or counts["attention_bwd_dkv"]):
            raise AssertionError("the fused step launched the two passes")
        torch.cuda.empty_cache()
    (two_s, two_peak), (fused_s, fused_peak) = list(rates.values())[2:]
    log(f"  bfloat16 step: fused flash backward {fused_s:.1f} tok/s, peak "
        f"{fused_peak / 2**30:.2f} GiB; two passes {two_s:.1f} tok/s, peak "
        f"{two_peak / 2**30:.2f} GiB; {card}")
    log("chunked attention through flash_block, GPT-2 small's attention "
        "width:")
    for dtype, counts in phase_chunked(card).items():
        tally(f"chunked attention ({dtype})", counts, FLASH_BLOCK_KERNELS)
    lap("GPT-2 training, chunked attention")
    log("lightgrad tape, BERT-base masked LM, float32, AdamW:")
    bert, flash, lens = phase_bert(card)
    tally("BERT-base (masked)", bert, BERT_KERNELS)
    tally("BERT-base (unmasked)", flash, FLASH_KERNELS)
    tally("BERT-base (attention_lengths)", lens, BERT_LENGTHS_KERNELS)
    log("lightgrad tape, BERT-base after quantize_module (int8 Linear):")
    phase_quant_bert()
    lap("BERT-base")
    log("conv path on the tape, ResNet-18 (torchvision widths), float32, "
        "AdamW:")
    counts = phase_resnet18(card)
    tally("ResNet-18", counts, CONV_PATH_KERNELS)
    if any(counts[k] for k in CONV_SIMT_KERNELS):
        raise AssertionError("a ResNet-18 conv took the CUDA-core route")
    log("narrow at a device start:")
    phase_narrow()
    lap("ResNet-18, narrow")
    serving, int8 = phase_llama_serving(card)
    for name, counts in serving.items():
        tally(f"{name} serving", counts, LLAMA_DEVICE_PATHS.get(
            name.split(" ", 1)[-1], LLAMA_SERVING_KERNELS))
    for (name, mode, path), counts in int8.items():
        tally(f"{name} {mode} {path}", counts, int8_path_kernels(mode, path))
    for name, counts in phase_llama_train(card).items():
        tally(f"{name} training", counts, LLAMA_TRAIN_KERNELS)
    lap("LLaMA family")
    model, paths = phase_mixtral_serving(card)
    for path, counts in paths.items():
        tally(f"Mixtral-8x7B {path}", counts, MIXTRAL_PATHS[path])
    log("int8 serving, Mixtral-8x7B (experts in bf16):")
    for (mode, path), counts in phase_llama_int8(
            model, "Mixtral-8x7B", MIXTRAL_PROMPT, card).items():
        tally(f"Mixtral-8x7B {mode} {path}", counts,
              int8_path_kernels(mode, path))
    del model
    torch.cuda.empty_cache()
    for name, counts in phase_mixtral_train(card).items():
        tally(name, counts, MOE_TRAIN_KERNELS)
    log("one bfloat16 MixedPrecision step on the tape, BERT-base and "
        "ResNet-18:")
    for name, counts in phase_amp_one_step(card).items():
        tally(f"{name} AMP step", counts, BERT_KERNELS if name.startswith(
            "BERT") else CONV_PATH_KERNELS)
    lap("Mixtral, AMP steps")
    for name, counts in phase_neox_train(card).items():
        tally(f"{name} training", counts, NEOX_TRAIN_KERNELS)
    log("Pythia-1B generate on the tape, float32, greedy:")
    t0 = time.perf_counter()
    tally("Pythia-1B generate", phase_neox_generate(card),
          NEOX_GENERATE_KERNELS)
    log(f"  Pythia-1B generate phase: {time.perf_counter() - t0:.1f} s")
    lap("Pythia")
    log("scanned GPT-2 small (the JAX bench's configuration), bf16 "
        "MixedPrecision Adam under WarmupCosine, remat False / dots / full:")
    t0 = time.perf_counter()
    for path, counts in phase_scan_train(card).items():
        tally(path, counts, ("attention_fwd", "decode_stack")
              if "generate" in path else TRAINING_KERNELS)
    log(f"  scanned GPT-2 phase: {time.perf_counter() - t0:.1f} s")
    log("checkpoint resume, bit for bit:")
    t0 = time.perf_counter()
    for path, counts in phase_checkpoint(card).items():
        tally(path, counts, BERT_KERNELS if path.startswith("BERT")
              else TRAINING_KERNELS)
    log(f"  checkpoint phase: {time.perf_counter() - t0:.1f} s")
    log("LoRA at Mistral-7B's widths (2 layers), bf16, q_proj / v_proj at "
        "rank 8, AdamW under WarmupCosine:")
    tally("Mistral-7B LoRA", phase_lora(card), LLAMA_TRAIN_KERNELS)
    log("serving I/O: tokenizers, save_pretrained / from_pretrained:")
    for path, counts in phase_serving_io(card).items():
        tally(path, counts, ("attention_fwd", "decode_stack")
              if "generate" in path else
              ("elementwise", "matmul", "layernorm_fwd", "attention_fwd"))
    lap("scan, checkpoints, LoRA, serving I/O")
    log("ViT-B/16 (google/vit-base-patch16-224's widths) on the tape, "
        "float32 AdamW, then one bf16 MixedPrecision step:")
    t0 = time.perf_counter()
    for path, counts in phase_vit(card).items():
        tally(path, counts, VIT_KERNELS)
    log(f"  ViT-B/16 phase: {time.perf_counter() - t0:.1f} s")
    log("the numpy oracle: CudaTensor ops on the card vs CpuTensor:")
    t0 = time.perf_counter()
    for path, counts in phase_oracle(card).items():
        tally(path, counts, GRADCHECK_KERNELS if path == "gradcheck"
              else ORACLE_KERNELS)
    log(f"  oracle phase: {time.perf_counter() - t0:.1f} s")
    lap("ViT-B/16, the oracle")
    log("T5-base (google-t5/t5-base's widths) on the tape, float32 "
        "Adafactor, then serving:")
    t0 = time.perf_counter()
    for path, counts in phase_t5(card, results).items():
        tally(path, counts, T5_KERNELS if "training" in path
              else T5_DECODE_KERNELS)
    log(f"  T5 phase: {time.perf_counter() - t0:.1f} s")
    log("GPT-MoE at GPT-2 small's widths (8 experts, top-2, capacity 1.25), "
        "float32 AdamW, then a bf16 MixedPrecision step and a Switch-style "
        "step:")
    t0 = time.perf_counter()
    for path, counts in phase_gpt_moe(card, results).items():
        tally(path, counts, GPT_MOE_KERNELS)
    log(f"  GPT-MoE phase: {time.perf_counter() - t0:.1f} s")
    lap("T5, GPT-MoE")
    log("the parallel layer at world size 1: BERT-base under BERT_TP_RULES "
        "with ring attention, the ring's chunked merge at Mistral-7B's "
        "attention width, GPT-2 small through 1F1B at pp 1, cached decode "
        "at tp 1, a sharded checkpoint:")
    t0 = time.perf_counter()
    for path, counts in phase_parallel(card).items():
        tally(path, counts, PARALLEL_BERT_KERNELS if path.startswith("BERT")
              else FLASH_BLOCK_KERNELS if path.startswith("ring")
              else ("attention_fwd", "decode_stack") if "decode" in path
              else TRAINING_KERNELS)
    log(f"  parallel phase: {time.perf_counter() - t0:.1f} s")
    lap("the parallel layer")
    log("the JAX package's examples on the port (lightgrad_tpu_torch/"
        "examples/), each through its own function:")
    t0 = time.perf_counter()
    for path, (counts, kernels) in phase_examples(card).items():
        tally(path, counts, kernels)
    log(f"  examples phase: {time.perf_counter() - t0:.1f} s")
    lap("the examples")
    log("the step compiler (lightgrad_tpu_torch.jit): compiled steps against "
        "eager steps from one start, BERT-base, ResNet-18, bf16 AMP with an "
        "overflow, dropout, the guards:")
    t0 = time.perf_counter()
    for path, counts in phase_step_compiler(card).items():
        tally(f"{path}, compiled", counts,
              CONV_PATH_KERNELS if path.startswith("ResNet")
              else BERT_LENGTHS_KERNELS if "lengths" in path
              else BERT_KERNELS)
    log(f"  step compiler phase: {time.perf_counter() - t0:.1f} s")
    lap("the step compiler")
    log("compiled decoding (models/decoding.py ParamFn: CUDA graphs) "
        "against the same calls eager, GPT-2 small f32 / bf16 / int8, "
        "Mistral-7B bf16 at 16 layers, T5-base:")
    t0 = time.perf_counter()
    for path, counts in phase_compiled_decoding(card).items():
        tally(path, counts, COMPILED_PATHS[next(
            k for k in COMPILED_PATHS if k in path)])
    log(f"  compiled decoding phase: {time.perf_counter() - t0:.1f} s")
    lap("compiled decoding")
    missing = [k for k in KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels no path launched: {missing}")

    kernels = []
    for name in KERNELS:
        route, src, replaces = KERNEL_SOURCES[name]
        rec = {"name": name, "route": route, "source": src,
               "replaces": replaces, "launches": launches[name],
               **results[name]}
        if name in KERNEL_NOTES:
            rec["note"] = KERNEL_NOTES[name]
        lacking = [k for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms") if k not in rec]
        if lacking:
            raise AssertionError(f"{name}: no {lacking} measured")
        kernels.append(rec)
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
