"""Synthetic task suite — the band-2 quality testbed.

No public LLDM weights can be loaded in this container, so the paper's
quality claims are gated on small masked-diffusion LMs trained from scratch
on tasks whose answers are *bidirectionally constrained* — decode order
provably matters, which is exactly the regime FDM targets:

* ``sum``      a+b with carries: low digits are locally easy, high digits
               depend on carry chains — committing them too early is the
               canonical order-induced error.
* ``sort``     output = sorted input digits: every position constrains all
               others through the global multiset.
* ``parity``   copy the bits, then append block parities: copies are easy,
               parities depend on everything.
* ``bracket``  close a bracket prefix: the correct token at position i
               depends on the entire suffix structure.
* ``reverse``  output = reversed input (sanity task, order-insensitive).

Each task emits fixed-geometry (prompt, answer) strings so batches are
static shapes.  Difficulty knobs are module constants.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, List, Tuple

SUM_DIGITS = 2          # operands up to 10^2-1, answer width 3
SORT_LEN = 12
PARITY_BITS = 9
PARITY_BLOCKS = 3
BRACKET_LEN = 10
REVERSE_LEN = 12


def _sum_example(rng: random.Random) -> Tuple[str, str]:
    a = rng.randrange(10 ** SUM_DIGITS)
    b = rng.randrange(10 ** SUM_DIGITS)
    prompt = f"{a:0{SUM_DIGITS}d}+{b:0{SUM_DIGITS}d}="
    answer = f"{a + b:0{SUM_DIGITS + 1}d}"
    return prompt, answer


def _sort_example(rng: random.Random) -> Tuple[str, str]:
    digits = [rng.randrange(10) for _ in range(SORT_LEN)]
    prompt = "".join(map(str, digits)) + ">"
    answer = "".join(map(str, sorted(digits)))
    return prompt, answer


def _parity_example(rng: random.Random) -> Tuple[str, str]:
    bits = [rng.randrange(2) for _ in range(PARITY_BITS)]
    prompt = "".join(map(str, bits)) + "="
    per = PARITY_BITS // PARITY_BLOCKS
    pars = [str(sum(bits[i * per:(i + 1) * per]) % 2)
            for i in range(PARITY_BLOCKS)]
    answer = "".join(map(str, bits)) + "".join(pars)
    return prompt, answer


def _bracket_example(rng: random.Random) -> Tuple[str, str]:
    """A prefix of opens/closes that needs exactly BRACKET_LEN closers,
    mixing () and [] so the *type* of each closer is order-constrained."""
    kinds = "([" if rng.random() < 0.9 else "(("
    stack: List[str] = []
    prefix = []
    while len(stack) < BRACKET_LEN:
        c = rng.choice(kinds)
        prefix.append(c)
        stack.append(c)
        # occasionally close one early to vary structure
        if stack and rng.random() < 0.25 and len(prefix) < 2 * BRACKET_LEN - 2:
            top = stack.pop()
            prefix.append(")" if top == "(" else "]")
            if len(stack) == 0:
                continue
    prompt = "".join(prefix)[-2 * BRACKET_LEN:] or "("
    # recompute the open stack of the (possibly trimmed) prompt
    stack = []
    for c in prompt:
        if c in "([":
            stack.append(c)
        elif stack:
            stack.pop()
    answer = "".join(")" if c == "(" else "]" for c in reversed(stack))
    answer = answer[:BRACKET_LEN].ljust(BRACKET_LEN, ".")
    prompt = prompt.rjust(2 * BRACKET_LEN, ".")
    return prompt + "=", answer


def _reverse_example(rng: random.Random) -> Tuple[str, str]:
    s = "".join(rng.choice("abcdefghij") for _ in range(REVERSE_LEN))
    return s + "<", s[::-1]


TASKS: Dict[str, Callable[[random.Random], Tuple[str, str]]] = {
    "sum": _sum_example,
    "sort": _sort_example,
    "parity": _parity_example,
    "bracket": _bracket_example,
    "reverse": _reverse_example,
}


def task_geometry(task: str) -> Tuple[int, int]:
    """(prompt_len, answer_len) — fixed per task for static batch shapes."""
    rng = random.Random(0)
    p, a = TASKS[task](rng)
    return len(p), len(a)
