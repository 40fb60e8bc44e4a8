"""What the local-LLM cell's driver and its controls share: the model's
weights, drawn by the harness itself, the model the program loads (an HF
config.json and a LOCAL_LLM_CONFIG TOML), the documents and the asks, and
the comparison that decides `correct`.

The comparison, for a seeded sample of the window's completed asks:

  - replay: the program's own `prefill` and one `model_forward` decode
    step a token, teacher-forced on the prompt and the emitted ids at the
    timed bucket and cache shapes; `replay_mismatch` counts the emitted
    ids that are not the greedy choice of the replayed logits (0: the
    replayed logits are those the timed path chose from);
  - the reference (`reference/deepseek_v2.py`, float32, TF32 off, on the
    harness's own draw of the weights, read by HF's names) over prompt +
    answer, at the positions that chose each answer id:
    `worst_logit_err`, the RMS of (program - reference) over the RMS of
    the centred reference logits, and `worst_choice_gap`, the reference's
    best logit less its logit of the emitted id, over the std of its
    logits; both the worst over every compared position;
  - the routing: every MoE layer of the replay, seen through the program's
    `moe_tap` at `MOE_ROWS` rows of the prompt and at every answer
    position, against the reference's MoE layer on the same input rows:
    `moe_choice_mismatch`, the share of rows whose set of chosen experts
    is not the reference's, and `moe_routed_err`, the worst over layers
    of the norm of (program - reference) routed sum over the norm of the
    reference's. The logits alone hardly see the routed experts: with
    random weights the router's softmax over 64 experts is nearly flat,
    and the sixth expert left out moved them about as much as bf16
    rounding does.

And the cell's end-to-end `recall_at_10`, as the search cells' recall:
at every compared answer position and at `PROMPT_ROWS` rows of each
prompt (the program's own prefill over the prompt again, its head at
those rows: the next id of the document), the share of the program's 10
highest logits whose reference logit reaches the reference's 10th best,
the mean over every position of the sample.
"""

from __future__ import annotations

import json
import math
import os
from collections import defaultdict

import numpy as np
import torch

from .common import derive, log, rng
from .corpus import lognormal_ints
from .reference import deepseek_v2 as ref

SHAPE_SEED = 3  # the seed of the prompt lengths, the same in every run
MOE_ROWS = 32   # prompt rows a replayed prefill's MoE layers are compared at
PROMPT_ROWS = 1024  # prompt rows whose next-id logits recall_at_10 ranks

# Keys of a configuration file that are the harness's, not the model's.
HARNESS_KEYS = frozenset({"name", "source", "deployment", "max_context", "param_dtype",
                          "assumed", "reduced", "rehearsal"})

# The extraction asks: a request and the JSON Schema of its answer.
ASKS = [
    ("List every person named in the text.",
     {"type": "object", "properties": {"people": {"type": "array", "items": {"type": "string"}}},
      "required": ["people"]}),
    ("Give the title and the date of the document.",
     {"type": "object", "properties": {"title": {"type": "string"},
                                       "date": {"type": "string"}}}),
    ("Extract each monetary amount with its currency.",
     {"type": "array", "items": {"type": "object", "properties": {
         "amount": {"type": "number"}, "currency": {"type": "string"}}}}),
    ("State the main claim of the text in one sentence.",
     {"type": "object", "properties": {"claim": {"type": "string"}}, "required": ["claim"]}),
    ("Which organisations are mentioned, and how often?",
     {"type": "object", "additionalProperties": {"type": "integer"}}),
    ("Name the three key terms of the text.",
     {"type": "array", "items": {"type": "string"}, "minItems": 3, "maxItems": 3}),
]


def hf_config(config: dict) -> dict:
    """The model's HF config.json: the configuration file's own keys."""
    return {k: v for k, v in config.items() if k not in HARNESS_KEYS}


def write_model(config: dict, out_dir: str) -> str:
    """config.json and the LOCAL_LLM_CONFIG TOML of the run (greedy
    decoding; the weights are handed to the loader in memory); the TOML's
    path."""
    model_dir = os.path.join(out_dir, "model")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w", encoding="utf-8") as fh:
        json.dump(hf_config(config), fh)
    toml = os.path.join(out_dir, "llm.toml")
    with open(toml, "w", encoding="utf-8") as fh:
        fh.write(f'[model]\npath = "{model_dir}"\nname = "{config["name"]}"\n'
                 f'param_dtype = "{config["param_dtype"]}"\n'
                 f"max_context = {int(config['max_context'])}\n"
                 "[sampler]\ntemperature = 0.0\nrepetition_penalty = 1.0\n")
    return toml


def hf_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    """Every tensor of an HF DeepSeek-V2 checkpoint without q_lora_rank,
    by name ([out, in] matmul weights)."""
    H, V, L = hf["hidden_size"], hf["vocab_size"], hf["num_hidden_layers"]
    nh, dn, dr, dv, r = (hf["num_attention_heads"], hf["qk_nope_head_dim"],
                         hf["qk_rope_head_dim"], hf["v_head_dim"], hf["kv_lora_rank"])
    K, E = hf.get("first_k_dense_replace", 0), hf["n_routed_experts"]
    Ie, I = hf["moe_intermediate_size"], hf["intermediate_size"]
    Is = Ie * hf["n_shared_experts"]
    out = {"model.embed_tokens.weight": (V, H), "model.norm.weight": (H,),
           "lm_head.weight": (V, H)}

    def mlp(pre: str, width: int) -> None:
        out.update({pre + "gate_proj.weight": (width, H), pre + "up_proj.weight": (width, H),
                    pre + "down_proj.weight": (H, width)})

    for i in range(L):
        pre = f"model.layers.{i}."
        out.update({pre + "input_layernorm.weight": (H,),
                    pre + "self_attn.q_proj.weight": (nh * (dn + dr), H),
                    pre + "self_attn.kv_a_proj_with_mqa.weight": (r + dr, H),
                    pre + "self_attn.kv_a_layernorm.weight": (r,),
                    pre + "self_attn.kv_b_proj.weight": (nh * (dn + dv), r),
                    pre + "self_attn.o_proj.weight": (H, nh * dv),
                    pre + "post_attention_layernorm.weight": (H,)})
        if i < K:
            mlp(pre + "mlp.", I)
            continue
        out[pre + "mlp.gate.weight"] = (E, H)
        mlp(pre + "mlp.shared_experts.", Is)
        for e in range(E):
            mlp(pre + f"mlp.experts.{e}.", Ie)
    return out


class DrawnWeights:
    """The model's weights as the harness draws them, under HF's names in
    the configuration's dtype, as a checkpoint holds them: each tensor
    from a generator of its own on the device, seeded by the run's seed
    and the tensor's name, so that any tensor is drawn again alike
    whenever it is asked for (the program's loader and the reference each
    read the whole model a tensor at a time, and no second copy is kept).
    Matrices 0.02 * N(0, 1), the router's too; norm weights 1 + 0.1 *
    N(0, 1), so that a norm read in another's place shows."""

    def __init__(self, hf: dict, seed: int, device: str, dtype: str):
        self.shapes = hf_shapes(hf)
        self.seed, self.device = seed, torch.device(device)
        self.dtype = getattr(torch, dtype)

    def get(self, name: str) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(derive(self.seed, "weights", name))
        t = torch.randn(self.shapes[name], generator=g, device=self.device, dtype=torch.float32)
        if name.endswith("norm.weight"):
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.02)
        return t.to(self.dtype)


def make_docs(traffic: dict, seed: int, overhead: int) -> list[str]:
    """`docs` ASCII documents of seeded words whose prompts come to the
    traffic's log-normal lengths in ids (one id a byte; `overhead` ids of
    the chat template, the request and the schema taken off), drawn once
    from a fixed seed and put in the run seed's order."""
    lens = lognormal_ints(np.random.default_rng(SHAPE_SEED), int(traffic["docs"]),
                          traffic["prompt_ids"])
    g = rng(seed, "llm_docs")
    lens = g.permutation(lens)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(g.choice(letters, int(n))) for n in g.integers(2, 10, 4096)]
    docs = []
    for n in lens:
        budget = int(n) - overhead
        parts, size = [], 0
        while size < budget:
            w = words[int(g.integers(0, len(words)))]
            parts.append(w)
            size += len(w) + 1
        docs.append(" ".join(parts)[:budget])
    return docs


def make_asks(traffic: dict, seed: int, n_docs: int) -> list[tuple[int, int]]:
    """(document, ask) of every request in order: each document asked
    `asks_per_doc` different asks in a row."""
    g = rng(seed, "llm_asks")
    per = int(traffic["asks_per_doc"])
    return [(d, int(a)) for d in range(n_docs) for a in g.permutation(len(ASKS))[:per]]


def messages(prompter, doc: str, ask: int):
    query, schema = ASKS[ask]
    return prompter.json_schema_extraction(doc, query, schema)


def overhead_ids(llm, prompter, render_chat) -> int:
    """The most ids a prompt adds to its document, over every ask (the
    BOS and the template's bytes)."""
    return max(1 + len(llm.tokenizer.encode(render_chat(messages(prompter, "", a))))
               for a in range(len(ASKS)))


def replay(llm, msgs, ids: list[int]):
    """The program's logits [len(ids), V] at the positions that chose
    `ids`: its own prefill at the timed bucket, then one decode step a
    token fed the emitted id, as `generate`'s steps. Also the prompt's
    ids, how many emitted ids the replayed logits do not choose, what
    the MoE layers' tap saw: (layer, input rows float32, expert ids,
    routed sum) at MOE_ROWS prompt rows of the prefill and at every
    decode step, and the program's logits [R, V] at R = PROMPT_ROWS rows
    of the prompt with those rows (a second prefill, its head there)."""
    from memex_tpu_torch.llm.local.deepseek_v2 import moe_tap
    from memex_tpu_torch.llm.local.model import init_cache, model_forward, prefill

    padded, n, _ = llm.encode_prompt(msgs, len(ids))
    rows = torch.linspace(0, n - 1, min(n, MOE_ROWS), device=padded.device).round().long()
    seen: list = []

    def tap(layer, x, weights, idx, routed, shared):
        pick = rows if x.shape[0] > 1 else slice(None)
        seen.append((layer, x[pick].float(), idx[pick].clone(), routed[pick].clone()))

    with torch.no_grad(), moe_tap(tap):
        cache, last, _, pos, _ = prefill(llm.cfg, llm.params, padded, n, llm.sampler)
        out = [last]
        for t in ids[:-1]:
            tok = torch.full((), t, dtype=torch.long, device=padded.device)
            logits, cache = model_forward(llm.cfg, llm.params, tok.view(1, 1), pos.view(1, 1),
                                          cache, pos)
            pos = pos + 1
            out.append(logits[0, 0])
    prog = torch.stack(out)
    chosen = torch.as_tensor(ids, device=prog.device)
    mismatch = int((prog.argmax(dim=-1) != chosen).sum())
    del cache
    at = torch.linspace(0, max(n - 2, 0), min(max(n - 1, 1), PROMPT_ROWS),
                        device=padded.device).round().long().unique()
    P = padded.shape[1]
    with torch.no_grad():
        rows, _ = model_forward(llm.cfg, llm.params, padded,
                                torch.arange(P, device=padded.device)[None, :],
                                init_cache(llm.cfg, batch=1, device=padded.device), 0,
                                logits_at=at)
    return prog, padded[0, :n].tolist(), mismatch, seen, (at.tolist(), rows[0])


def recall10(prog: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Tie-aware recall@10 a row: the share of the program's 10 highest
    logits whose reference logit reaches the reference's 10th best."""
    top = prog.topk(10, dim=-1).indices
    tenth = want.topk(10, dim=-1).values[:, -1:]
    return (want.gather(1, top) >= tenth).float().mean(dim=-1)


def compare(hf: dict, w, prompt: list[int], ids: list[int], prog: torch.Tensor,
            prompt_rows: tuple[list[int], torch.Tensor]) -> tuple[float, float, torch.Tensor]:
    """(worst logit error, worst choice gap, recall@10 a position) of the
    program's logits against the reference's over prompt + answer: error
    and gap at the answer positions, recall there and at the prompt rows."""
    n = len(prompt)
    at, at_logits = prompt_rows
    both = ref.logits(hf, w, prompt + ids[:-1], at + list(range(n - 1, n - 1 + len(ids))))
    want_at, want = both[:len(at)], both[len(at):]
    prog = prog.to(want.device, torch.float32)
    recall = torch.cat([recall10(at_logits.to(want.device, torch.float32), want_at),
                        recall10(prog, want)])
    centred = want - want.mean(dim=-1, keepdim=True)
    err = (prog - want).pow(2).mean(-1).sqrt() / centred.pow(2).mean(-1).sqrt()
    chosen = torch.as_tensor(ids, device=want.device)
    gap = ((want.max(dim=-1).values - want.gather(1, chosen[:, None])[:, 0])
           / want.std(dim=-1))
    return float(err.max()), float(gap.max()), recall


def compare_moe(hf: dict, w, seen: list) -> tuple[float, float]:
    """(share of tapped rows whose chosen experts are not the reference's,
    worst routed-sum error over the layers), each MoE layer's rows of
    every sample compared at once with the reference's layer on the same
    input rows."""
    by_layer = defaultdict(list)
    for layer, x, idx, routed in seen:
        by_layer[layer].append((x, idx, routed))
    rows = missed = 0
    worst = 0.0
    for layer, items in sorted(by_layer.items()):
        x, idx, routed = (torch.cat([it[i] for it in items]) for i in range(3))
        want_idx, want_routed, _ = ref.moe(hf, w, layer, x)
        rows += x.shape[0]
        if idx.shape != want_idx.shape:
            missed += x.shape[0]
        else:
            same = idx.sort(dim=-1).values == want_idx.sort(dim=-1).values
            missed += int((~same.all(dim=-1)).sum())
        worst = max(worst, float((routed - want_routed).norm() / want_routed.norm()))
    return (missed / rows if rows else math.inf), (worst if rows else math.inf)


def readings(hf: dict, w, llm, samples: list) -> dict:
    """The numbers compared with the cell's limits, over `samples`
    [(messages, emitted ids)], against the reference on the weights `w`
    (by HF name); no sample, or an ask that emitted nothing, reads inf
    (and its recall 0)."""
    mismatch, worst_err, worst_gap = 0, 0.0, 0.0
    if not samples:
        worst_err = worst_gap = math.inf
    seen: list = []
    recalls: list = []
    for msgs, ids in samples:
        if not ids:
            worst_err = worst_gap = math.inf
            recalls.append(torch.zeros(1))
            continue
        prog, prompt, miss, taps, prompt_rows = replay(llm, msgs, ids)
        seen += taps
        mismatch += miss
        err, gap, recall = compare(hf, w, prompt, ids, prog, prompt_rows)
        recalls.append(recall.cpu())
        log(f"check: prompt {len(prompt)} ids, answer {len(ids)}, replay mismatch {miss}, "
            f"logit err {err:.6f}, choice gap {gap:.6f}, recall@10 {float(recall.mean()):.6f} "
            f"at {recall.numel()} positions")
        worst_err, worst_gap = max(worst_err, err), max(worst_gap, gap)
    choice, routed = compare_moe(hf, w, seen)
    log(f"check: {len(seen)} MoE taps, choice mismatch {choice:.6f}, routed err {routed:.6f}")
    return {"replay_mismatch": float(mismatch), "worst_logit_err": worst_err,
            "worst_choice_gap": worst_gap, "moe_choice_mismatch": choice,
            "moe_routed_err": routed, "asks": len(samples),
            "recall_at_10": float(torch.cat(recalls).mean()) if recalls else 0.0}
