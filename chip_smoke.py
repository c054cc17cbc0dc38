"""Smoke run of the PyTorch port's paths on one NVIDIA GPU: GPT-2 serving (float
and int8) and training (torch.autograd; two-pass and fused flash backward),
chunked attention through ``flash_block``, BERT-base masked-LM training
(padding mask and ``attention_lengths``), its int8 ``QuantLinear`` forward,
the gradient-descent example, the conv path (ResNet-18 training, the
MNIST CNN and ResNet-20 examples) on the lightgrad tape, the LLaMA
family (Mistral-7B and Gemma-2B serving, and training on the tape; the
char example), and the GPT-NeoX / Pythia family (Pythia-1B and -2.8B
training on the tape through the fused flash backward; Pythia-1B
``generate``).

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
     backward against its plain version evaluated in float64;
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
     with the float and the int8 cache;
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
  7. the tape's smallest path, examples/gradient_descent.py's loop (64 x 64)
     for 20 epochs: the loss must fall;
  8. the conv path on the tape, float32: (a) ResNet-18 at its torchvision
     widths (7x7/s2 stem, 3x3/s2 max pool, stages of 64-512, 1000 classes;
     seeded random weights) on 32 x 3 x 224 x 224 random images, AdamW, 5
     steps on one batch -- the loss must be finite and fall, step 1's
     logits and every parameter's gradient must match a plain twin (the
     ``_reference`` versions under torch autograd, in f32 and f64), the
     BatchNorm running statistics must move and an eval forward be finite;
     (b) examples/mnist.py's CNN (AdaBelief) and examples/resnet.py's
     ResNet-20 (AdamW) for 40 steps each through data.MNIST ->
     DeviceDataset.offsets() -> narrow on synthetic digits
     (LIGHTGRAD_FAKE_DATA=1) -- the loss must fall; test accuracy over
     2,000 digits; and one ``narrow`` forward + backward at a device start
     under ``torch.cuda.set_sync_debug_mode("error")``;
  9. the LLaMA family at its published widths, seeded random weights:
     (a) serving in bfloat16, Mistral-7B (all 32 layers; 8192 positions,
     cut from 32768) with a 4500-token prompt and Gemma-2B (all 18 layers,
     W 8192) with a 1000-token prompt: ``generate``, ``generate_batch``,
     an engine of 4 slots over 8 ragged requests, a teacher-forced check of
     prefill + cached steps against a plain full-sequence forward, and
     Mistral's check in float32 at 4 layers; a profiled prefill, step and
     engine tick (``step_batch`` over 4 slots: its launches, ms a token,
     device idle share, one batched decode-attention launch a layer); (b)
     training on the tape,
     float32, AdamW, 5 steps on one batch at full width cut to 2 layers:
     Mistral-7B on 1 x 8192 tokens (window active), Gemma-2B on 2 x 1024
     (head dim 256), each with step 1's logits and gradients against a
     plain twin; (c) examples/llama.py's char model (40 steps, then 120
     generated tokens);
 10. the GPT-NeoX / Pythia family at its published widths, seeded random
     weights, on the tape in float32 with ``set_flash_fused(True)``: (a)
     Pythia-1B (all 16 layers, head dim 256, rotary_pct 0.25, parallel
     residual; 1.01 B parameters) and Pythia-2.8B (2 of 32 layers, head
     dim 80) trained with AdamW, 5 steps on 2 x 2048 and 1 x 2048 tokens,
     step 1's logits and gradients against a plain twin, the fused kernel
     launched and the two passes not; (b) Pythia-1B greedy ``generate``,
     8 tokens after a 64-token prompt, each the argmax of the twin's
     logits on the same 2048-token window;
 11. every kernel of each path was launched by that path, and every kernel
     of the package by some path.
The line before the last is a JSON object of per-kernel results; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

import importlib
import json
import os
import subprocess
import sys
import time

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
# examples/mnist.py and examples/resnet.py: batch 128; about 40 steps here
MNIST_BATCH, MNIST_STEPS = 128, 40
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
# examples/llama.py's char model (its vocabulary: README.md's characters)
CHAR_LLAMA = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=192)
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
# One H100 SXM (NVIDIA's data sheet, dense rates at 700 W): HBM bytes
# a second and dense peak operations a second by input type
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
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def timed(results, dtype, name, err, kernel, plain, cost, library,
          iters=20, variant="", peak=None):
    """Record ``kernel``, ``plain`` and ``library`` by device time (graph
    replay)."""
    record(results, dtype, name, err, graph_ms(kernel, iters),
           graph_ms(plain, iters), timing="graph", cost=cost,
           library_ms=graph_ms(library, iters), variant=variant, peak=peak)


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
            x1 = rnd(1, d)
            record(results, dtype, name, 0.0,
                   cuda_ms(lambda: decode_stack(x1, c, 512, sl, vecs, scl,
                                                eps=eps, kv_scales=kvs)),
                   cuda_ms(lambda: decode_stack_reference(
                       x1, c, 512, sl, vecs, scl, eps=eps, kv_scales=kvs), 5),
                   cost=stack_cost(1, L, d, H, [512], dtype, scl is not None,
                                   kvs is not None))
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
        for sfx, sl, scl, c, kvs in variants:
            name = "decode_stack_batch" + sfx
            got = decode_stack_batch(xb, c, poss, sl, vecs, scl, eps=eps,
                                     kv_scales=kvs)
            want = decode_stack_batch_reference(xb, c, poss, sl, vecs, scl,
                                                eps=eps, kv_scales=kvs)
            err = max(check(f"{name} B=8 x", dtype, got[0], want[0], tol),
                      check(f"{name} B=8 kv", dtype, got[1], want[1], tol))
            record(results, dtype, name, err,
                   cuda_ms(lambda: decode_stack_batch(
                       xb, c, poss, sl, vecs, scl, eps=eps, kv_scales=kvs)),
                   cuda_ms(lambda: decode_stack_batch_reference(
                       xb, c, poss, sl, vecs, scl, eps=eps, kv_scales=kvs),
                       5),
                   cost=stack_cost(B, L, d, H, poss.tolist(), dtype,
                                   scl is not None, kvs is not None))
        del caches, caches8, bkvs8, slabs, vecs
        torch.cuda.empty_cache()


def plain_forward(model, ids, p=None):
    """Logits (..., T, vocab) of a full causal forward of ``ids`` (..., T)
    through the plain PyTorch versions of the kernels: no cache, no
    hand-written kernel -- the reference the KV path and, under autograd,
    the training step must meet.  ``p`` replaces the model's parameters
    (a "head.weight" entry replaces the tied head)."""
    import torch.nn.functional as F

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

    x = p["wte.weight"][ids] + p["wpe.weight"][:T]
    for l in range(cfg.n_layer):
        pre = f"h.{l}."
        qkv = lin(ln(x, pre + "ln_1"), pre + "attn.c_attn")
        q, k, v = (t.reshape(*lead, T, H, d // H).transpose(-3, -2)
                   for t in qkv.split(d, -1))
        att = attention_fwd_reference(q, k, v, (d // H) ** -0.5, True)[0]
        x = x + lin(att.transpose(-3, -2).reshape(*lead, T, d),
                    pre + "attn.c_proj")
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
    rng7 = np.random.default_rng(7)
    reqs = [([int(t) for t in rng7.integers(0, vocab,
                                            int(rng7.integers(8, 49)))],
             int(rng7.integers(16, 129))) for _ in range(32)]
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


def phase_int8_serving(model, dtype):
    """int8 serving for one dtype under each of quantize_serving,
    quantize_kv and both: the serving entry points, then the teacher-
    forced checks.  Returns {mode: launch counts}."""
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
        counts[mode] = launch_counts()   # before the check's own launches
        teacher_forced_int8(model, dtype, mode, rng)
        model.quantize_serving(False).quantize_kv(False)
        torch.cuda.empty_cache()
    return counts


def phase_long_context(model):
    """The regime the int8 cache is for: a 960-token prompt and 48 new
    tokens through ``generate``, float cache and ``quantize_kv``; the
    decode rate leaves out the prefill (a 1-token run timed apart)."""
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

    from lightgrad_tpu_torch.ops.elementwise import ew, ew_reference
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
        # two-gradient add, a scalar multiply.  The mask is the path's own:
        # 0 on valid keys, -1e9 past lengths drawn from 64-128.
        h, gh = rnd(R, f), rnd(R, f)
        scores = rnd(B, H, S, S, scale=2.0)
        mask = ((torch.arange(S, device=dev) >= lengths[:, None]) * -1e9
                ).reshape(B, 1, 1, S).to(dtype)
        x, y = rnd(R, d), rnd(d)
        err = 0.0
        for body, args, n_out in (
                ("f_gelu", (h,), 1), ("b_gelu", (gh, h), 1),
                ("f_add", (scores, mask), 1), ("b2_add", (x, x, y), 2),
                ("f_mul", (x, torch.tensor(0.125, device=dev)), 1)):
            got = ew(body, *args, n_out=n_out)
            want = ew_reference(body, *args, n_out=n_out)
            for i, (a, b) in enumerate(zip(*(
                    (t,) if n_out == 1 else t for t in (got, want)))):
                err = max(err, check(f"elementwise {body}[{i}] "
                                     f"{tuple(a.shape)}", dtype, a, b, tol))
        timed(results, dtype, "elementwise", err, lambda: ew("f_gelu", h),
              lambda: ew_reference("f_gelu", h),
              (2 * R * f * isz, 10 * R * f),
              lambda: F.gelu(h, approximate="tanh"))

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
        timed(results, dtype, "softmax_fwd", err, lambda: softmax_fwd(sm),
              lambda: softmax_fwd_reference(sm),
              (2 * sm.numel() * isz, 5 * sm.numel()),
              lambda: torch.softmax(sm, -1))
        gs = rnd(B, H, S, S)
        want = softmax_bwd_reference(gs, ys)
        err = check(f"softmax_bwd {tuple(gs.shape)}", dtype,
                    softmax_bwd(gs, ys), want, tol)
        discriminates("softmax_bwd", dtype, want, tol, torch.zeros_like(want))
        timed(results, dtype, "softmax_bwd", err,
              lambda: softmax_bwd(gs, ys),
              lambda: softmax_bwd_reference(gs, ys),
              (3 * gs.numel() * isz, 4 * gs.numel()),
              lambda: torch._softmax_backward_data(gs, ys, -1, dtype))
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
    BERT's key projection's bias has a zero gradient in exact arithmetic
    (softmax ignores a per-row constant), so its error is taken relative to
    the same layer's query bias gradient."""
    tol = PATH_TOL[torch.float32]
    twins = {32: grads32, 64: grads64}
    twins = {bits: g for bits, g in twins.items() if g is not None}
    rel = {bits: {} for bits in twins}
    for name, t in model.named_parameters():
        got = t.grad.data.double()
        if not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {name} is not finite")
        ref_name = name.replace("self.key.bias", "self.query.bias")
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
                   ("sum_partials", "conv"), ("sum_dw", "conv"))


def step_breakdown(step, step_s, host_s):
    """Where one tape step's time goes: the tape's ops a step (counted by
    the tape's own profiler), the host time that queues forward + backward
    per op, and the device time of each kernel family in one step traced by
    torch.profiler, with the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lightgrad_tpu_torch.utils.profiler import Profiler

    with Profiler() as prof:
        step()
    n_fwd = sum(prof.fwd_count.values())
    n_bwd = sum(prof.bwd_count.values())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        step()
        torch.cuda.synchronize()
    fams = [f for _, f in KERNEL_FAMILIES] + ["plain torch"]
    ms, n = dict.fromkeys(fams, 0.0), dict.fromkeys(fams, 0)
    for e in trace.events():
        if e.device_type == DeviceType.CUDA:
            fam = next((f for k, f in KERNEL_FAMILIES if k in e.name),
                       "plain torch")
            ms[fam] += e.time_range.elapsed_us() / 1e3
            n[fam] += 1
    busy = sum(ms.values())
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


def phase_tape_example():
    """Phase 7: examples/gradient_descent.py's loop (64 x 64) for 20 epochs
    on the card; returns its launch counts."""
    import lightgrad_tpu_torch as lt
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    lt.random.seed(0)
    a, b, c = (lt.uniform(-1, 1, (64, 64)) for _ in range(3))
    reset_launch_counts()
    losses = []
    for _ in range(20):
        y = (a.tanh() + b.sigmoid()) @ (c.relu() - a.sigmoid())
        loss = (y * y).sum()
        for p in (a, b, c):
            p.zero_grad()
        loss.backward()
        with lt.no_grad():
            for p in (a, b, c):
                p += p.grad * (-0.001)
        losses.append(loss.item())
    counts = launch_counts()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    log(f"  losses {losses[0]:.3f} -> {losses[-1]:.3f} over 20 epochs "
        f"({'falling' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"gradient descent loss not falling: {losses}")
    return counts


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


def mnist_cnn():
    """examples/mnist.py's CNN on the port's layers."""
    from lightgrad_tpu_torch import nn

    class CNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2d(1, 8, kernelsize=3, pad=1)
            self.c2 = nn.Conv2d(8, 16, kernelsize=3, pad=1)
            self.l1 = nn.Linear(7 * 7 * 16, 10)

        def forward(self, x):
            y = self.c1(x).max_pool(kernel=(2, 2)).relu()
            y = self.c2(y).max_pool(kernel=(2, 2)).relu()
            return self.l1(y.reshape(y.shape[0], -1))

    return CNN()


def train_digits(model, opt, train, test, card):
    """The examples' loop, eagerly: MNIST_STEPS steps of batches narrowed
    from the resident set by DeviceDataset.offsets(), then the accuracy of
    an eval() pass over the test digits.  Returns the steps' launch
    counts."""
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import no_grad
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    xs, ys = train.tensors
    B = MNIST_BATCH
    losses = []
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(losses) < MNIST_STEPS:
        for off in train.offsets():
            if len(losses) >= MNIST_STEPS:
                break
            x = xs.narrow(off, B).reshape(B, 1, 28, 28)
            loss = lg_loss.cross_entropy(model(x), ys.narrow(off, B))
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
    dt = time.perf_counter() - t0
    counts = launch_counts()
    model.eval()
    correct = total = 0
    with no_grad():
        for x, y in test:
            pred = model(x.reshape(x.shape[0], 1, 28, 28)).numpy().argmax(-1)
            correct += int((pred == y.numpy()).sum())
            total += len(pred)
    model.train()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    ok = all(np.isfinite(losses)) and last < first
    log(f"  {MNIST_STEPS} steps in {dt:.2f} s ({MNIST_STEPS / dt:.1f} "
        f"steps/s, eager); loss {first:.4f} -> {last:.4f} (means of the "
        f"first and last 5 steps, {'falling' if ok else 'FAIL'}); test "
        f"accuracy {correct / total:.4f} over {total} digits; {card}")
    if not ok:
        raise AssertionError(f"loss not finite and falling: {losses}")
    return counts


def phase_digits(card):
    """Phase 8b: the JAX examples' own paths on synthetic digits:
    examples/mnist.py's CNN (AdaBelief, lr 3e-3) and examples/resnet.py's
    ResNet-20 (AdamW, lr 3e-3, weight decay 0.01), batch 128, through
    data.MNIST -> DeviceDataset.offsets() -> narrow.  Returns {name: launch
    counts}."""
    from lightgrad_tpu_torch import data, optim, random as lg_random
    from lightgrad_tpu_torch.models import resnet20

    os.environ["LIGHTGRAD_FAKE_DATA"] = "1"
    mnist = data.MNIST(train=True, batchsize=MNIST_BATCH)
    train = data.DeviceDataset(mnist.tensors, batchsize=MNIST_BATCH)
    test = data.MNIST(train=False, n=2_000, shuffle=False, batchsize=256)
    log(f"  {train.n} training digits resident on the card, "
        f"{test.n} test digits")
    counts = {}
    lg_random.seed(0)
    model = mnist_cnn()
    log("  MNIST CNN (examples/mnist.py), AdaBelief lr 3e-3:")
    counts["MNIST CNN"] = train_digits(
        model, optim.AdaBelief(list(model.parameters()), lr=3e-3), train,
        test, card)
    lg_random.seed(0)
    model = resnet20(num_classes=10, in_channels=1)
    log("  ResNet-20 (examples/resnet.py), AdamW lr 3e-3, weight decay "
        "0.01:")
    counts["ResNet-20"] = train_digits(
        model, optim.AdamW(list(model.parameters()), lr=3e-3,
                           weight_decay=0.01), train, test, card)
    del model, train, test, mnist
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
    """Causal (banded) grouped-query attention for the LLaMA twins: the
    flash kernels' plain versions (``attention_fwd_reference``,
    ``attention_bwd_reference``), one KV group at a time, so the f32 scores
    of a long sequence exist for one group at once; the backward recomputes
    them.  q (b, H, S, hd), k and v (b, KV, S, hd)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window):
        from lightgrad_tpu_torch.ops.attention import attention_fwd_reference

        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.window = scale, window
        return torch.cat([attention_fwd_reference(qg, kg, vg, scale, True,
                                                  window=window)[0]
                          for (qg,), (kg, vg) in _kv_groups(q, k, v)], 1)

    @staticmethod
    def backward(ctx, g):
        from lightgrad_tpu_torch.ops.attention import attention_bwd_reference

        q, k, v = ctx.saved_tensors
        parts = [attention_bwd_reference(gg, qg, kg, vg, ctx.scale, True,
                                         window=ctx.window)
                 for (qg, gg), (kg, vg) in _kv_groups(q, k, v,
                                                      extra=(g,))]
        dq, dk, dv = (torch.cat(t, 1) for t in zip(*parts))
        return dq, dk, dv, None, None


def plain_llama(p, cfg, ids):
    """Logits (b, T, vocab) of ``Llama.forward`` through the plain PyTorch
    versions of the kernels (``_reference``), differentiable by torch
    autograd, attention one KV group at a time: the twin of the tape's step
    and the full-sequence reference of the KV path.  Computes in ``p``'s
    dtype, every product summed in f32 and rounded once.  Its RoPE tables
    are its own: pair i of position t turns by t * theta^(-2i / hd), in numpy
    f32 arithmetic as the model's (torch's f32 power differs by an ulp at
    some i, which moves position 8191's angles by up to 1e-3)."""
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
        att = _PlainAttention.apply(q, k, v, hd ** -0.5, win)
        x = x + lin(att.transpose(1, 2).reshape(b, T, H * hd),
                    pre + "self_attn.o_proj")
        h2 = rms(x, pre + "post_attention_layernorm")
        g = lin(h2, pre + "mlp.gate_proj")
        a = ew_reference("f_gelu", g) if cfg.hidden_act != "silu" \
            else torch.sigmoid(g) * g
        x = x + lin(a * lin(h2, pre + "mlp.up_proj"), pre + "mlp.down_proj")
    x = rms(x, "norm")
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


def teacher_forced_llama(model, name, dtype, P, steps=4):
    """Prefill of P random tokens, then ``steps`` cached steps, against the
    plain full-sequence forward (``plain_llama``) at PATH_TOL."""
    cfg = model.cfg
    rng = np.random.default_rng(P)
    seq = [int(t) for t in rng.integers(0, cfg.vocab_size, P + steps)]
    fns = model._kv_functions()
    dev = model.embed_tokens.weight.device
    toks = torch.zeros(cfg.max_position_embeddings, dtype=torch.long)
    toks[:P] = torch.tensor(seq[:P])
    with torch.no_grad():
        cache, lg = fns.prefill(fns.init_cache(), toks.to(dev), P)
        rows = [lg]
        for pos in range(P, len(seq)):
            cache, lg = fns.step(cache, pos, seq[pos])
            rows.append(lg)
        del cache
        p = {n: t.data for n, t in model.named_parameters()}
        want = plain_llama(p, cfg, torch.tensor([seq], device=dev))[0, P - 1:]
    check(f"{name} teacher-forced prefill of {P} + {steps} cached steps vs "
          f"the plain forward", dtype, torch.stack(rows), want,
          PATH_TOL[dtype])
    del rows, want, fns
    torch.cuda.empty_cache()


# kernel-name fragment -> the family a serving call's device time is summed
# under (bf16 cuBLAS GEMMs on the H100 are nvjet_* kernels)
SERVING_FAMILIES = (("flash_fwd", "flash forward"),
                    ("decode_attention", "decode attention"),
                    ("decode_merge", "decode attention"),
                    ("nvjet", "cuBLAS GEMM"), ("gemm", "cuBLAS GEMM"),
                    ("cutlass", "cuBLAS GEMM"))


def serving_breakdown(model, name, P, slots=4):
    """Where a prefill (the prompt padded to the window), one cached step
    and one engine tick (``step_batch`` over ``slots`` slots near P) go:
    device time by kernel family in one warm call of each traced by
    torch.profiler, against the call's wall time, with the kernels a call
    launches; the tick must launch the batched decode attention once a
    layer for all slots."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    fns = model._kv_functions()
    W, L = model.cfg.max_position_embeddings, model.cfg.num_hidden_layers
    dev = model.embed_tokens.weight.device
    toks = torch.randint(0, model.cfg.vocab_size, (W,), device=dev)
    cache = fns.init_cache()
    caches = torch.stack([fns.init_cache() for _ in range(slots)])
    poss = torch.tensor([P + 3 * b for b in range(slots)], device=dev,
                        dtype=torch.int32)
    ticks = torch.randint(0, model.cfg.vocab_size, (slots,), device=dev)
    calls = (("prefill", lambda: fns.prefill(cache, toks, P)),
             ("step", lambda: fns.step(cache, P, 7)),
             (f"engine tick (step_batch, {slots} slots)",
              lambda: fns.step_batch(caches, poss, ticks)))
    for what, call in calls:
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
        for e in trace.events():
            if e.device_type == DeviceType.CUDA:
                fam = next((f for k, f in SERVING_FAMILIES if k in e.name),
                           "plain torch")
                ms[fam] += e.time_range.elapsed_us() / 1e3
                n[fam] += 1
        busy = sum(ms.values())
        log(f"  {name} {what} (profiled): device {busy:.2f} ms of "
            f"{wall * 1e3:.2f} ms wall (idle "
            f"{100 * (1 - busy / (wall * 1e3)):.1f}%), {sum(n.values())} "
            f"kernels: "
            + ", ".join(f"{f} {t:.2f} ms ({n[f]})" for f, t in ms.items()))
        if what.startswith("engine tick"):
            log(f"  {name} engine tick: {sum(n.values())} launches for "
                f"{slots} slots, {wall * 1e3 / slots:.3f} ms of wall time a "
                f"token; decode_attention_batch launched "
                f"{counts['decode_attention_batch']} times for {L} layers")
            if counts["decode_attention_batch"] != L \
                    or counts["decode_attention"]:
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


def phase_llama_serving(card):
    """Serving at the published widths, bfloat16, seeded random weights:
    Mistral-7B (32 layers; max_position_embeddings cut from 32768 to 8192,
    the cache window and the prefill length) with a 4500-token prompt, so
    prefill and decode run past the 4096 band, and Gemma-2B (18 layers, W
    8192, no cut) with a 1000-token prompt: ``generate``,
    ``generate_batch``, an engine, and the teacher-forced check against the
    plain forward; then Mistral-7B's check in float32 at 4 layers.  Returns
    {path: launch counts}."""
    counts = {}
    for name, cfg, P, batch_lens, engine_lens in LLAMA_SERVING:
        log(f"serving path, {name}, bfloat16, all "
            f"{cfg['num_hidden_layers']} layers (W "
            f"{cfg['max_position_embeddings']}):")
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = llama_model(cfg, torch.bfloat16)
        n = sum(t.numel() for t in model.parameters())
        log(f"  {n / 1e9:.3f} B parameters, "
            f"{n * 2 / 1e9:.2f} GB in bf16; built in "
            f"{time.perf_counter() - t0:.1f} s (peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
        counts[name] = drive_llama_serving(model, name, P, batch_lens,
                                           engine_lens)
        serving_breakdown(model, name, P)
        teacher_forced_llama(model, name, torch.bfloat16, P)
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
    return counts


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


def phase_llama_example(card):
    """examples/llama.py's char model on the tape, float32: hidden 128, 4
    layers, 4 heads, 2 KV heads (head dim 32), 192 positions; Adam at 3e-4,
    40 steps of 16 x 64 characters of README.md, then ``generate`` of 120
    tokens at temperature 0.6.  The loss must fall.  Returns the launch
    counts of both."""
    from lightgrad_tpu_torch import loss as lg_loss
    from lightgrad_tpu_torch import optim
    from lightgrad_tpu_torch.autograd import Tensor
    from lightgrad_tpu_torch.ops import launch_counts, reset_launch_counts

    here = os.path.dirname(os.path.abspath(__file__))
    text = open(os.path.join(here, "README.md")).read()
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    data = np.array([stoi[c] for c in text], dtype=np.int32)
    steps, batch, seq = 40, 16, 64
    model = llama_model(dict(CHAR_LLAMA, vocab_size=len(chars)),
                        torch.float32)
    opt = optim.Adam(list(model.parameters()), lr=3e-4)
    rng = np.random.default_rng(0)
    starts = rng.integers(0, len(data) - seq - 1, steps * batch)
    xs = Tensor.from_numpy(np.stack([data[s:s + seq] for s in starts]),
                           requires_grad=False)
    ys = Tensor.from_numpy(np.stack([data[s + 1:s + seq + 1]
                                     for s in starts]), requires_grad=False)
    reset_launch_counts()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        x, y = xs.narrow(i * batch, batch), ys.narrow(i * batch, batch)
        logits = model(x).reshape(batch * seq, len(chars))
        loss = lg_loss.cross_entropy(logits, y.reshape(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.generate([stoi.get(c, 0) for c in "lightgrad"],
                         max_new_tokens=120, temperature=0.6)
    gen_s = time.perf_counter() - t0
    counts = launch_counts()
    ok = all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(
        losses[:5])
    log(f"  corpus {len(data)} chars, vocab {len(chars)}; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps "
        f"({steps / dt:.1f} steps/s; {'falling' if ok else 'FAIL'})")
    log(f"  generate: 120 tokens in {gen_s:.2f} s ({120 / gen_s:.1f} tok/s): "
        f"{''.join(chars[i] for i in out)!r}")
    if not ok or len(out) != 9 + 120:
        raise AssertionError(f"char LLaMA: losses {losses}, {len(out)} "
                             f"tokens")
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

    def rope(x):
        xr = x[..., :rot]
        x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
        return torch.cat([xr * cos + torch.cat([-x2, x1], -1) * sin,
                          x[..., rot:]], -1)

    def attn(h, pre):
        qkv = lin(h, pre + "attention.query_key_value")
        qkv = qkv.reshape(b, T, H, 3 * hd).transpose(1, 2)
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        att = _PlainAttention.apply(rope(q), rope(k), v, hd ** -0.5, 0)
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
    del model, p, got, logits
    torch.cuda.empty_cache()
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from lightgrad_tpu_torch import GPT, GPTConfig
    from lightgrad_tpu_torch.ops import KERNELS, _build

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
    log(f"build: nvcc {_build.build_seconds():.1f} s, loaded in "
        f"{time.perf_counter() - t0:.1f} s; stack kernel grids (blocks) "
        f"{grids}")
    if not all(grids.values()):
        raise AssertionError(f"a stack kernel instantiation was refused: "
                             f"{grids}")

    dev = torch.device("cuda")
    model = GPT(GPTConfig(**GPT2_SMALL), device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))

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
        for k in KERNELS:
            launches[k] += counts[k]

    for dtype in (torch.float32, torch.bfloat16):
        if dtype != torch.float32:
            model.to(dtype)
        log(f"serving path, GPT-2 small, {str(dtype)[6:]}:")
        tally(f"serving ({dtype})", phase_main_path(model, dtype),
              SERVING_KERNELS)
        for mode, counts in phase_int8_serving(model, dtype).items():
            sfx = INT8_MODES[mode]
            tally(f"int8 serving, {mode} ({dtype})", counts,
                  ("decode_stack" + sfx, "decode_stack_batch" + sfx))
    log("long context, GPT-2 small, bfloat16:")
    phase_long_context(model)
    del model
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
    log("lightgrad tape, BERT-base masked LM, float32, AdamW:")
    bert, flash, lens = phase_bert(card)
    tally("BERT-base (masked)", bert, BERT_KERNELS)
    tally("BERT-base (unmasked)", flash, FLASH_KERNELS)
    tally("BERT-base (attention_lengths)", lens, BERT_LENGTHS_KERNELS)
    log("lightgrad tape, BERT-base after quantize_module (int8 Linear):")
    phase_quant_bert()
    log("lightgrad tape, gradient descent example (64 x 64):")
    tally("gradient descent", phase_tape_example(), TAPE_KERNELS)
    log("conv path on the tape, ResNet-18 (torchvision widths), float32, "
        "AdamW:")
    counts = phase_resnet18(card)
    tally("ResNet-18", counts, CONV_PATH_KERNELS)
    if any(counts[k] for k in CONV_SIMT_KERNELS):
        raise AssertionError("a ResNet-18 conv took the CUDA-core route")
    log("conv path on the tape, the JAX examples on synthetic digits, "
        "float32:")
    for name, counts in phase_digits(card).items():
        tally(name, counts, DIGITS_KERNELS[name])
    log("narrow at a device start:")
    phase_narrow()
    for name, counts in phase_llama_serving(card).items():
        tally(f"{name} serving", counts, LLAMA_SERVING_KERNELS)
    for name, counts in phase_llama_train(card).items():
        tally(f"{name} training", counts, LLAMA_TRAIN_KERNELS)
    log("examples/llama.py's char model on the tape, float32:")
    t0 = time.perf_counter()
    tally("char LLaMA", phase_llama_example(card),
          LLAMA_TRAIN_KERNELS + ("decode_attention",))
    log(f"  char LLaMA phase: {time.perf_counter() - t0:.1f} s")
    for name, counts in phase_neox_train(card).items():
        tally(f"{name} training", counts, NEOX_TRAIN_KERNELS)
    log("Pythia-1B generate on the tape, float32, greedy:")
    t0 = time.perf_counter()
    tally("Pythia-1B generate", phase_neox_generate(card),
          NEOX_GENERATE_KERNELS)
    log(f"  Pythia-1B generate phase: {time.perf_counter() - t0:.1f} s")
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
