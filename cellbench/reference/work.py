"""The least work of a flush, reckoned from its query specs and the
configuration's sizes.

Never from the program's plans or a kernel's arguments, so a program that
fuses, reorders or removes kernels is held to the same work.  A page is
one bitmap over every user (``words`` 32-bit words).  A predicate
``("days", d)`` reads the last d day pages.

- sense: every distinct day page the flush's predicates read, once (the
  windows share their newest days), plus the valid-user page; every
  distinct predicate's result written once;
- reduce: every distinct COUNT's result read once by its count;
- payload: every distinct MASK's words and 8 bytes per COUNT, written
  once.

Operations are 32-bit word operations: one per word of every page the
sensing reads.  At the card's rates the bytes bind.
"""

from __future__ import annotations


def flush_work(words: int, members: list[tuple]) -> dict:
    """Least bytes and operations of one flush of ``(pred, agg)`` members."""
    page = 4 * int(words)
    preds = {p for p, _ in members}
    counted = {p for p, a in members if a[0] == "count"}
    masks = {p for p, a in members if a[0] == "mask"}
    read = max((int(p[1]) for p in preds), default=0)
    sense = (read + 1 + len(preds)) * page
    reduce = len(counted) * page
    payload = len(masks) * page + 8 * sum(1 for _, a in members if a[0] == "count")
    return {"sense_bytes": sense, "reduce_bytes": reduce, "payload_bytes": payload, "ops": (read + 1) * int(words)}


def least_seconds(work: dict, peak: dict) -> float:
    """A flush's bound: its bytes at the memory's rate or its operations at
    the integer rate, whichever is larger."""
    total = work["sense_bytes"] + work["reduce_bytes"] + work["payload_bytes"]
    return max(total / peak["hbm_bytes_per_s"], work["ops"] / peak["int32_ops_per_s"])
