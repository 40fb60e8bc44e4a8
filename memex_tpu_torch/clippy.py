"""clippy: the example RAG client (memex_tpu's examples/clippy.py) against a
running memex service, either package's server.

    python -m memex_tpu_torch.clippy [--host URL] [--local-llm CFG] [--device cuda|cpu] CMD

  load-file <path>   POST the file's contents into the `clippy` collection
  ask <question>     top-2 semantic search -> prompt with context -> answer
  qq <question>      quick question, no retrieval
  forget             DELETE the `clippy` collection

Answers come from the service's /api/action/ask, or with `--local-llm CFG`
from the port's local LLM run here (`LocalLLM.from_config`, the TOML
schema of LOCAL_LLM_CONFIG), its tokens printed live as they stream off
the device. The model loads once a process, on `--device` (default cuda;
without a card the command exits 2 unless it is given `--device cpu`).
HTTP goes through the standard library.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

DEFAULT_HOST = "http://127.0.0.1:8181"
COLLECTION = "clippy"

PROMPT_TEMPLATE = """Today's date: {today}

Use the following context to answer the question at the end. If the context
is not helpful, answer from general knowledge and say so.

Context:
{context}

Question: {question}
"""


def _request(method: str, url: str, body: dict | None = None,
             timeout: float = 60.0) -> tuple[int, dict]:
    """(status, JSON body) of one request; an HTTP error status is returned,
    not raised, with its body."""
    data = None if body is None else json.dumps(body).encode()
    headers = {} if data is None else {"Content-Type": "application/json"}
    req = urllib.request.Request(url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as exc:
        raw = exc.read()
        try:
            return exc.code, json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return exc.code, {"message": raw[:200].decode(errors="replace")}


def _checked(method: str, url: str, body: dict | None = None,
             timeout: float = 60.0) -> dict:
    status, out = _request(method, url, body, timeout)
    if status >= 400:
        raise RuntimeError(f"{method} {url}: HTTP {status}: {out}")
    return out


def health_check(host: str) -> None:
    try:
        _checked("GET", f"{host}/api/health", timeout=5)
    except (OSError, RuntimeError) as exc:
        print(f"error: memex service not reachable at {host} ({exc})", file=sys.stderr)
        sys.exit(1)


def wait_for_task(host: str, task_id: int, timeout: float = 300.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = _request("GET", f"{host}/api/tasks/{task_id}", timeout=10)
        result = body.get("result") or {}
        if status != 200 or "status" not in result:
            # Error envelope ({code, message}) or a transient 5xx: a
            # readable message, not a KeyError.
            msg = result.get("message", f"HTTP {status}")
            if status == 404:
                raise RuntimeError(f"task {task_id} not found: {msg}")
            time.sleep(0.5)  # transient server error: keep polling
            continue
        if result["status"] in ("Completed", "Failed"):
            return result
        time.sleep(0.5)
    raise TimeoutError(f"task {task_id} still pending after {timeout}s")


def cmd_load_file(host: str, path: str) -> int:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        content = fh.read()
    task = _checked("POST", f"{host}/api/collections/{COLLECTION}",
                    {"content": content}, timeout=30)["result"]
    print(f"queued task {task['taskId']}; waiting for ingest...")
    result = wait_for_task(host, task["taskId"])
    print(f"ingest {result['status'].lower()}")
    return 0 if result["status"] == "Completed" else 1


def search_context(host: str, question: str, limit: int = 2) -> list[dict]:
    # Top-2 context, as the reference client (clippy main.rs:209).
    query = urllib.parse.urlencode({"query": question, "limit": limit})
    return _checked("GET", f"{host}/api/collections/{COLLECTION}/search?{query}")[
        "result"]["results"]


def llm_answer(host: str, prompt: str) -> str:
    _, body = _request("POST", f"{host}/api/action/ask",
                       {"text": prompt, "query": "Answer the question in the text."},
                       timeout=300)
    if body.get("status") != "ok":
        return f"(llm error: {body.get('result', {}).get('message')})"
    val = body["result"]["jsonResponse"]
    return val if isinstance(val, str) else json.dumps(val, indent=2)


class LocalAnswerer:
    """The port's local LLM, loaded on first use and kept for the process,
    answering with its text printed as it streams. `last` holds the latest
    answer's first_token_ms (the first generated id on the host),
    first_piece_ms (the first decodable text printed), total_ms, tokens
    (ids generated) and pieces (the streamed texts: a piece waits while
    its ids end inside a multi-byte character)."""

    def __init__(self, cfg_path: str, device: str):
        self.cfg_path, self.device = cfg_path, device
        self._llm = None
        self.last: dict = {}

    def answer(self, prompt: str) -> str:
        from .llm.base import ChatMessage, ChatRole
        from .llm.local import LocalLLM

        if self._llm is None:
            print("loading local model...", file=sys.stderr)
            self._llm = LocalLLM.from_config(self.cfg_path, device=self.device)
        llm = self._llm
        pieces: list[str] = []
        first: list[float] = []
        t0 = time.perf_counter()

        def emit(piece: str) -> None:
            if not first:
                first.append(time.perf_counter() - t0)
            pieces.append(piece)
            print(piece, end="", flush=True)  # live, as each piece decodes

        text = llm.chat_completion(llm.default_model, [ChatMessage(ChatRole.User, prompt)],
                                   on_token=emit)
        total = time.perf_counter() - t0
        first_id = llm.last_stream["first_id_at"]
        self.last = {"first_token_ms": None if first_id is None else (first_id - t0) * 1e3,
                     "first_piece_ms": first[0] * 1e3 if first else None,
                     "total_ms": total * 1e3, "tokens": llm.last_stream["ids"],
                     "pieces": pieces}
        print(f"\n[predict time: {total * 1e3:.0f}ms]", file=sys.stderr)
        return text


def cmd_ask(host: str, question: str, local: LocalAnswerer | None = None) -> int:
    t0 = time.perf_counter()
    segments = search_context(host, question)
    context = "\n---\n".join(s["content"] for s in segments) or "(no documents loaded)"
    prompt = PROMPT_TEMPLATE.format(today=dt.date.today().isoformat(), context=context,
                                    question=question)
    if local is not None:
        local.answer(prompt)  # streams to stdout itself
    else:
        print(llm_answer(host, prompt))
    print(f"\n[{len(segments)} context segments, {time.perf_counter() - t0:.2f}s]")
    return 0


def cmd_qq(host: str, question: str, local: LocalAnswerer | None = None) -> int:
    if local is not None:
        local.answer(question)
    else:
        print(llm_answer(host, question))
    return 0


def cmd_forget(host: str) -> int:
    _checked("DELETE", f"{host}/api/collections/{COLLECTION}")
    print(f"collection '{COLLECTION}' deleted")
    return 0


def main(argv: list[str] | None = None, local: LocalAnswerer | None = None) -> int:
    """The CLI. `local` passes in a loaded LocalAnswerer, so one process
    can run several commands on one model, as one clippy session does."""
    parser = argparse.ArgumentParser(prog="clippy", description=__doc__.split("\n\n")[0])
    parser.add_argument("--host", default=DEFAULT_HOST)
    parser.add_argument(
        "--local-llm", default=None, metavar="CFG",
        help="TOML model config: answer client-side with live token streaming")
    parser.add_argument("--device", default="cuda",
                        help="torch device of --local-llm's model (default cuda)")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("load-file")
    p.add_argument("path")
    p = sub.add_parser("ask")
    p.add_argument("question")
    p = sub.add_parser("qq")
    p.add_argument("question")
    sub.add_parser("forget")
    args = parser.parse_args(argv)

    if args.local_llm and local is None:
        from .runtime import require_device

        if require_device(args.device, "clippy --local-llm") is None:
            return 2
        local = LocalAnswerer(args.local_llm, args.device)
    elif not args.local_llm:
        local = None
    health_check(args.host)
    if args.command == "load-file":
        return cmd_load_file(args.host, args.path)
    if args.command == "ask":
        return cmd_ask(args.host, args.question, local)
    if args.command == "qq":
        return cmd_qq(args.host, args.question, local)
    if args.command == "forget":
        return cmd_forget(args.host)
    return 2


if __name__ == "__main__":
    sys.exit(main())
