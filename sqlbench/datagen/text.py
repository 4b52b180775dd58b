"""Text columns as TPC-H's dbgen makes them: random substrings of a pool of
pseudo-text (TPC-H spec rev. 3.0.1, 4.2.2.10), and random alphanumeric
v-strings (4.2.2.7).

The spec's pool is 300 MB of sentences from its grammar; this one is 1 MiB
of words from the same word lists in random order (an assumption the
configurations list), made from the seed like everything else.
"""

from __future__ import annotations

import numpy as np

from .rowv2 import Text

# TPC-H spec 4.2.2.13: nouns, verbs, adjectives, adverbs, prepositions and
# auxiliaries of the text grammar (a subset of each list)
WORDS = (
    "foxes ideas theodolites pinto beans instructions dependencies excuses platelets asymptotes courts dolphins"
    " multipliers sauternes warthogs frets dinos attainments somas Tiresias' patterns forges braids hockey"
    " players frays warhorses dugouts notornis epitaphs pearls tithes waters orbits gifts sheaves depths"
    " sentiments decoys realms pains grouches escapades sleep wake are cajole haggle nag use boost affix"
    " detect integrate maintain nod was lose sublate solve thrash promise engage hinder print x-ray breach"
    " eat grow impress mold poach serve run dazzle snooze doze unwind kindle play hang believe doubt"
    " furious sly careful blithe quick fluffy slow quiet ruthless thin close dogged daring brave stealthy"
    " permanent enticing idle busy regular final ironic even bold silent sometimes always never furiously"
    " slyly carefully blithely quickly fluffily slowly quietly ruthlessly thinly closely doggedly daringly"
    " bravely stealthily permanently enticingly idly busily regularly finally ironically evenly boldly"
    " silently about above according to across after against along alongside of among around at atop"
    " before behind beneath beside besides between beyond by despite during except for from in place of"
    " inside instead of into near of on outside over past since through throughout to toward under until"
    " up upon without with within do may might shall will would can could should ought to must will have"
    " to shall have to could have to should have to must have to need to try to"
).split()
POOL_BYTES = 1 << 20
ALNUM = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ,. ", np.uint8)


def pool(rng: np.random.Generator) -> np.ndarray:
    """POOL_BYTES of words in random order, separated by spaces."""
    words = [w.encode() + b" " for w in WORDS]
    picks = rng.integers(0, len(words), POOL_BYTES // 4)
    out = np.frombuffer(b"".join(words[i] for i in picks.tolist()), np.uint8)
    return out[:POOL_BYTES].copy()


def pool_text(rng: np.random.Generator, text_pool: np.ndarray, n: int, lo: int, hi: int) -> Text:
    """n random substrings of the pool, of lengths uniform in [lo, hi]."""
    lens = rng.integers(lo, hi + 1, n)
    start = rng.integers(0, len(text_pool) - hi, n)
    mat = text_pool[start[:, None] + np.arange(hi)[None, :]]
    return Text(mat, lens.astype(np.int64))


def v_string(rng: np.random.Generator, n: int, lo: int, hi: int) -> Text:
    """n random alphanumeric strings of lengths uniform in [lo, hi]; the
    last character is never a space, so CHAR columns keep them whole."""
    lens = rng.integers(lo, hi + 1, n)
    mat = ALNUM[rng.integers(0, len(ALNUM) - 3, (n, hi))]
    return Text(mat, lens.astype(np.int64))


def fixed_choice(rng: np.random.Generator, n: int, choices: list) -> tuple[Text, np.ndarray]:
    """n strings picked uniformly from `choices`, and the index of each."""
    idx = rng.integers(0, len(choices), n)
    return table_text(choices, idx), idx


def table_text(choices: list, idx: np.ndarray) -> Text:
    """choices[i] for each i of idx."""
    w = max(len(c) for c in choices)
    mat = np.zeros((len(choices), w), np.uint8)
    for i, c in enumerate(choices):
        mat[i, : len(c)] = np.frombuffer(c.encode(), np.uint8)
    lens = np.array([len(c) for c in choices], np.int64)
    return Text(mat[idx], lens[idx])


def formatted(prefix: str, values: np.ndarray, digits: int) -> Text:
    """prefix followed by each value zero-padded to `digits` digits
    ("Customer#000000042")."""
    v = np.asarray(values, np.int64)
    p = np.frombuffer(prefix.encode(), np.uint8)
    mat = np.empty((len(v), len(p) + digits), np.uint8)
    mat[:, : len(p)] = p
    for k in range(digits):
        mat[:, len(p) + k] = 48 + (v // 10 ** (digits - 1 - k)) % 10
    return Text(mat, np.full(len(v), len(p) + digits, np.int64))

