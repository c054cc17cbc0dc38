"""Some phases of ``chip_smoke.py`` alone, after the kernels' build: the
quickest way to check the step compiler or compiled decoding on the card
without the whole run.

    python3 scripts/smoke_phases.py [p16] [p15] [neox] [p17] [mixtral]

``p16``: phase 16, the step compiler (compiled steps against eager steps);
``p15``: phase 15, the examples, with each path's kernels checked launched;
``neox``: phase 10b, Pythia-1B's generate with its compiled decode;
``p17``: phase 17, compiled decoding (CUDA graphs of the decode functions
against the same calls eager, the decode kernels inside a replay);
``mixtral``: phase 9d and 9e, Mixtral-8x7B's serving and int8 serving, then
:func:`mixtral_prefill_rows` (run first: it needs 24 GB of weights).  With
no argument, ``p16``.  Each phase raises
on a failure, as in the whole run.
"""

import gc
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lightgrad_tpu_torch.ops import _build  # noqa: E402


def mixtral_prefill_rows(card, reps=10):
    """Mixtral-8x7B (phase 9d's cut, bf16) with its prefill's routed FFN
    over three row counts, in one run: the prompt's own ``n_real`` rows
    (one graph for each prompt length), the power-of-two bucket (the
    default) and all W rows.  For each: the compiled prefill of a
    MIXTRAL_PROMPT-token prompt (CUDA-event ms, median of ``reps``
    replays), then an engine of 4 slots over phase 9d's 8 requests run
    three times (the first two record and capture, the third replays), in
    tokens a second, and the graphs its admission holds."""
    from lightgrad_tpu_torch import InferenceEngine
    from lightgrad_tpu_torch.models.decoding import _kv

    model = cs.llama_model(cs.MIXTRAL_8X7B, torch.bfloat16, **cs.MIXTRAL_CUT)
    W, V, P = model.cfg.max_position_embeddings, model.cfg.vocab_size, \
        cs.MIXTRAL_PROMPT
    rng = np.random.default_rng(13)
    toks = torch.zeros(W, dtype=torch.long, device="cuda")
    toks[:P] = torch.from_numpy(rng.integers(0, V, P))
    news = [int(rng.integers(4, 17)) for _ in cs.MIXTRAL_ENGINE]
    reqs = [([int(t) for t in rng.integers(0, V, n)], k)
            for n, k in zip(cs.MIXTRAL_ENGINE, news)]
    fns = _kv(model)
    bucket = fns.prefill.static_of
    for label, rows in (("n_real rows", lambda c, t, n: (n,)),
                        ("bucket rows", bucket),
                        ("all W rows", lambda c, t, n: (W,))):
        fns.prefill.static_of = rows
        fns.prefill.release()
        cache = fns.init_cache()
        for _ in range(3):
            fns.prefill(cache, toks, P)
        ms = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fns.prefill(cache, toks, P)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        del cache
        engine = InferenceEngine(model, slots=4)
        rates = []
        for _ in range(3):
            handles = [engine.submit(p, k) for p, k in reqs]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run()
            torch.cuda.synchronize()
            rates.append(sum(news) / (time.perf_counter() - t0))
            assert all(h.n_generated == k for h, (_, k) in zip(handles, reqs))
        print(f"Mixtral-8x7B ({cs.MIXTRAL_CUT['num_hidden_layers']} layers, "
              f"W {W}) prefill of {P} tokens, routed FFN over {label} "
              f"({rows(None, None, P)[0]}): compiled "
              f"{float(np.median(ms)):.2f} ms (CUDA events, median of "
              f"{reps}); engine of 4 slots, requests "
              f"{list(cs.MIXTRAL_ENGINE)}: {rates[0]:.1f}, {rates[1]:.1f} and "
              f"{rates[2]:.1f} tok/s in its three runs; its admission "
              f"holds {len(engine._admit._sigs)} signatures; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
              flush=True)
        del engine
        torch.cuda.empty_cache()
    fns.prefill.static_of = bucket
    del model, fns
    torch.cuda.empty_cache()


def main(which):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if "mixtral" in which:
        t0 = time.perf_counter()
        model, paths = cs.phase_mixtral_serving(card)
        for (mode, path), counts in cs.phase_llama_int8(
                model, "Mixtral-8x7B", cs.MIXTRAL_PROMPT, card).items():
            paths[f"{mode} {path}"] = counts
        for path, counts in paths.items():
            print("Mixtral-8x7B", path, {k: v for k, v in counts.items()
                                         if v}, flush=True)
        del model
        torch.cuda.empty_cache()
        mixtral_prefill_rows(card)
        print(f"Mixtral phases: {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    if "p16" in which:
        t0 = time.perf_counter()
        for path, counts in cs.phase_step_compiler(card).items():
            print(path, {k: v for k, v in counts.items() if v}, flush=True)
        print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    if "p15" in which:
        t0 = time.perf_counter()
        for path, (counts, kernels) in cs.phase_examples(card).items():
            missing = [k for k in kernels if counts[k] == 0]
            print(path, f"missing {missing}" if missing else "ok",
                  flush=True)
            if missing:
                raise AssertionError(f"{path}: kernels not launched "
                                     f"{missing}")
        print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    if "neox" in which:
        t0 = time.perf_counter()
        cs.phase_neox_generate(card)
        print(f"phase 10b: {time.perf_counter() - t0:.1f} s", flush=True)
    if "p17" in which:
        t0 = time.perf_counter()
        for path, counts in cs.phase_compiled_decoding(card).items():
            print(path, {k: v for k, v in counts.items() if v}, flush=True)
        print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["p16"])
