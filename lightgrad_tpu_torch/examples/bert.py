"""BERT masked-LM inference.

Counterpart of ``examples/bert.py``: BERT from an HF checkpoint
(``bert-base-uncased`` through the fetch cache) and its WordPiece
tokenizer, the top-k tokens for ``[MASK]`` under ``no_grad``.  Offline the
example falls back to a random-initialized small config (4 layers, width
256, vocab 1000) and ``BertTokenizer.synthetic()``, so the whole path stays
runnable.  The forward runs on the tape's kernels (elementwise, reduce,
matmul, softmax, LayerNorm) compiled by ``lightgrad_tpu_torch.jit``; its
latency is timed after the record and compile calls.

    python -m lightgrad_tpu_torch.examples.bert [--text ...] [--device cpu]
"""

import time

import numpy as np

import lightgrad_tpu_torch as light
from lightgrad_tpu_torch.autograd.cuda.device import synchronize
from lightgrad_tpu_torch.examples import device_parser, on_device
from lightgrad_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                        BertTokenizer)


def load_model_and_tokenizer(offline_layers=4, offline_hidden=256):
    """(model, tokenizer, config) on the default device."""
    try:
        model, cfg = BertForMaskedLM.from_pretrained()
        tok = BertTokenizer.from_pretrained()
        print("loaded bert-base-uncased from HuggingFace")
    except Exception as e:  # noqa: BLE001 - air-gapped fallback
        print(f"checkpoint unavailable ({e}); using random-init small config")
        light.random.seed(0)
        cfg = BertConfig(
            vocab_size=1000,
            hidden_size=offline_hidden,
            num_hidden_layers=offline_layers,
            num_attention_heads=offline_hidden // 64,
            intermediate_size=offline_hidden * 4,
        )
        model, tok = BertForMaskedLM(cfg), BertTokenizer.synthetic()
    return model, tok, cfg


def infer(model, input_ids):
    """Logits of the masked-LM head, without a tape."""
    with light.no_grad():
        return model(input_ids)


def main(text="the capital of france is [MASK] .", topk=5, device="cuda"):
    with on_device(device):
        model, tok, cfg = load_model_and_tokenizer()
        ids = tok.encode(text)
        mask_pos = ids.index(tok.ids["[MASK]"]) \
            if tok.ids["[MASK]"] in ids else 1
        input_ids = light.Tensor.from_numpy(np.array([ids], dtype=np.int32),
                                            requires_grad=False)
        fn = light.jit(lambda x: infer(model, x))
        fn(input_ids)  # record (builds the kernels)
        fn(input_ids).numpy()  # compile
        synchronize()
        t0 = time.perf_counter()
        logits = fn(input_ids)
        synchronize()
        lat = time.perf_counter() - t0
        row = logits.numpy()[0, mask_pos]
    top = np.argsort(-row)[:topk]
    print(f"inference latency {lat * 1e3:.2f} ms (seq {len(ids)}, "
          f"{cfg.num_hidden_layers} layers)")
    print("top-k for [MASK]:", list(zip(tok.convert_ids_to_tokens(top),
                                        row[top].round(3))))
    return {"seconds": lat, "top": [int(i) for i in top], "row": row}


if __name__ == "__main__":
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--text", default="the capital of france is [MASK] .")
    ap.add_argument("--topk", type=int, default=5)
    args = ap.parse_args()
    main(args.text, args.topk, device=args.device)
