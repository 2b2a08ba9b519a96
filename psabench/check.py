"""What decides `correct`: every answer the window's requests returned,
compared with the plain reference's answer to the same query.

An answer is the winner tuple (offset, char_offset, sub_code, score), or
None for "no offset admits a substitution"; it is right when it equals the
reference's exactly, score bits included.  Each number compared has its
limit; the run is correct when every number is within its limit and at
least one answer was checked.
"""

from __future__ import annotations

# exact comparisons: a wrong answer or a failed request is one too many
LIMITS = {"wrong_answers": 0, "failed_requests": 0}


def reference_answers(pool: list, calls: set, tables, device) -> dict:
    """{pool index: [reference answer per query]} for the calls in `calls`."""
    from psabench import reference

    return {i: [reference.winner(s1, s2, tables, device) for s1, s2 in pool[i]]
            for i in sorted(calls)}


def compare(requests: list, answers: dict) -> dict:
    """The numbers compared: wrong answers among those checked, requests
    that raised or returned the wrong number of answers, and answers
    checked."""
    wrong = failed = checked = 0
    for r in requests:
        want = answers.get(r.call)
        if r.results is None or want is None or len(r.results) != len(want):
            failed += 1
            continue
        for got, ref in zip(r.results, want):
            checked += 1
            wrong += got != ref
    return {"wrong_answers": wrong, "failed_requests": failed,
            "checked": checked}


def verdict(numbers: dict) -> bool:
    return (numbers["checked"] > 0
            and all(numbers[k] <= lim for k, lim in LIMITS.items()))


def lines(numbers: dict) -> list:
    """One line a number compared: its name, its value, its limit."""
    out = [f"check {k} {numbers[k]} limit {lim}" for k, lim in LIMITS.items()]
    out.append(f"check checked {numbers['checked']} limit >= 1")
    return out


def as_json(numbers: dict) -> dict:
    out = {k: {"value": numbers[k], "limit": lim} for k, lim in LIMITS.items()}
    out["checked"] = {"value": numbers["checked"], "limit": ">= 1"}
    return out
