"""The port's ``_bulk`` rate at the shape of chip_smoke.py phase 16 (a):
documents of corpus.py's text (seed 0) with a keyword and a long, sent
over HTTP in requests of Rally's default ``bulk_size`` (5,000) to a node
of its own on a temporary data path (removed at the end), translog
included. Each run indexes into a new index, and the runs alternate two
ways for the indexer to take an ASCII text value:

  terms   ``StandardAnalyzer.index_terms``: a TermRun, the terms alone
          (the way the port ships)
  tokens  the analyzer's Token list (``analyze``), as any other value

in the order terms, tokens, tokens, terms, so a drift of the host's speed
shows as a difference between the two runs of one way. Prints one JSON
line: each run's docs/s, and the card's name and power limit.

    python3 bulk_rate.py [--docs 100000] [--device cuda]
"""

import argparse
import json
import shutil
import subprocess
import tempfile
import time
import urllib.request

import numpy as np

from elasticsearch_tpu_torch.analysis.analyzers import StandardAnalyzer
from elasticsearch_tpu_torch.corpus import build_corpus, term_name
from elasticsearch_tpu_torch.node import Node

BULK = 5_000
MAPPINGS = {"properties": {"body": {"type": "text"},
                           "tag": {"type": "keyword"},
                           "n": {"type": "long"}}}


def http(port, method, path, body, ndjson=False):
    data = body.encode() if ndjson else json.dumps(body).encode()
    ctype = "application/x-ndjson" if ndjson else "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data,
                                 {"Content-Type": ctype}, method=method)
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.load(r)


def bulk_bodies(n_docs):
    dc = build_corpus(np.random.default_rng(0), n_docs=n_docs)
    names = [term_name(t) for t in range(int(dc["stream"].max()) + 1)]
    ends = np.cumsum(dc["lens"].astype(np.int64))
    toks = np.split(dc["stream"], ends[:-1])
    tags = ["alpha", "beta", "gamma"]
    lines = [json.dumps({"index": {"_id": str(i)}}) + "\n" + json.dumps(
        {"body": " ".join([names[t] for t in toks[i].tolist()]),
         "tag": tags[i % 3], "n": i}) + "\n" for i in range(n_docs)]
    return ["".join(lines[lo:lo + BULK]) for lo in range(0, n_docs, BULK)]


def run(port, index, bodies, n_docs):
    st, _ = http(port, "PUT", f"/{index}", {"mappings": MAPPINGS})
    assert st == 200, st
    t0 = time.perf_counter()
    for body in bodies:
        st, r = http(port, "POST", f"/{index}/_bulk", body, ndjson=True)
        assert st == 200 and not r["errors"], str(r)[:300]
    return n_docs / (time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    bodies = bulk_bodies(args.docs)
    shipped = StandardAnalyzer.index_terms
    path = tempfile.mkdtemp(prefix="estpu-bulk-rate-")
    node = Node(device=args.device, data_path=path)
    runs = []
    try:
        port = node.start(0)
        for j, way in enumerate(["terms", "tokens", "tokens", "terms"]):
            StandardAnalyzer.index_terms = (
                shipped if way == "terms" else StandardAnalyzer.analyze)
            runs.append({"way": way, "docs_per_s": run(
                port, f"rate{j}", bodies, args.docs)})
    finally:
        StandardAnalyzer.index_terms = shipped
        node.close()
        shutil.rmtree(path, ignore_errors=True)
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps({"bulk_rate": runs, "docs": args.docs, "bulk": BULK,
                      "card": card}))


if __name__ == "__main__":
    main()
