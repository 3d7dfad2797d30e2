"""Private Merkle-proof lookups over a PIR bucket of subtrees
(reference lib/blyss-rs/src/proof.rs).

The full Merkle tree is split into: a public "cap" (top cap_height levels,
fetched in the clear) and subtrees of height subtree_height stored in a
bucket under keys "{level}-{idx_within_level}"; each bucket value is a JSON
list of the subtree's node values in level order. Proof fetches read only
the subtrees on the leaf's path — privately — then assemble sibling steps.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable

from .bucket import Bucket


@dataclass
class LookupCfg:
    bucket_url: str
    api_key: str
    cap_url: str
    subtree_height: int
    cap_height: int
    tree_height: int

    @staticmethod
    def from_json(s: str) -> "LookupCfg":
        v = json.loads(s)
        return LookupCfg(
            bucket_url=v["bucket_url"], api_key=v["api_key"],
            cap_url=v["cap_url"], subtree_height=v["subtree_height"],
            cap_height=v["cap_height"], tree_height=v["tree_height"])


@dataclass
class ProofStep:
    value: str
    pos: int   # 0 = sibling on the left, 1 = on the right


def get_subtree_indices(cfg: LookupCfg, identity_idx: int) -> list[str]:
    """Bucket keys of the subtrees on the path (proof.rs:65-82)."""
    keys = []
    cur_level = cfg.tree_height - cfg.subtree_height
    while cur_level >= cfg.cap_height - 1:
        idx_within_level = identity_idx >> (cfg.tree_height - 1 - cur_level)
        keys.append(f"{cur_level}-{idx_within_level}")
        if cur_level >= cfg.subtree_height:
            cur_level -= cfg.subtree_height - 1
        else:
            break
    return keys


def get_subproof(tree: list[str], tree_height: int, idx: int) -> list[ProofStep]:
    """Sibling path within one level-order subtree (proof.rs:85-100)."""
    out = []
    for level in range(1, tree_height):
        idx_within_level = (idx >> (tree_height - 1 - level)) ^ 1
        tree_idx = (1 << level) - 1 + idx_within_level
        out.append(ProofStep(value=tree[tree_idx], pos=idx_within_level & 1))
    out.reverse()
    return out


def construct_merkle_proof(cfg: LookupCfg, identity_idx: int,
                           subtrees: list[list[str]]) -> list[ProofStep]:
    cur_level = cfg.tree_height - cfg.subtree_height
    outer_idx = 0
    proof: list[ProofStep] = []
    while cur_level >= cfg.cap_height - 1:
        subtree = subtrees[outer_idx]
        outer_idx += 1
        idx_within_level = identity_idx >> (cfg.tree_height - 1 - cur_level)
        idx_within_subtree = (
            identity_idx >> (cfg.tree_height - 1
                             - (cur_level + cfg.subtree_height - 1))
        ) - idx_within_level * (1 << (cfg.subtree_height - 1))
        proof.extend(get_subproof(subtree, cfg.subtree_height,
                                  idx_within_subtree))
        if cur_level >= cfg.subtree_height:
            cur_level -= cfg.subtree_height - 1
        else:
            break
    return proof


def get_idx_within_cap(identity_idx: int, tree_height: int,
                       cap_height: int) -> int:
    return identity_idx >> ((tree_height - 1) - (cap_height - 1))


def fetch_merkle_proof_at_idx(bucket: Bucket, cfg: LookupCfg,
                              identity_idx: int,
                              cap: list[str]) -> list[ProofStep]:
    keys = get_subtree_indices(cfg, identity_idx)
    raw = bucket.private_read(keys)
    subtrees = [json.loads(r) for r in raw]
    proof = construct_merkle_proof(cfg, identity_idx, subtrees)
    proof.extend(get_subproof(
        cap, cfg.cap_height,
        get_idx_within_cap(identity_idx, cfg.tree_height, cfg.cap_height)))
    return proof


def private_fetch_merkle_proof(bucket: Bucket, cfg: LookupCfg,
                               identity_commitment: str,
                               cap: list[str]) -> list[ProofStep]:
    """identity -> index (private read), then the proof path
    (proof.rs:183-200)."""
    ic = identity_commitment.lower()
    if not ic.startswith("0x"):
        ic = "0x" + ic
    idx_raw = bucket.private_read([ic])[0]
    if idx_raw is None:
        raise KeyError(identity_commitment)
    index = json.loads(idx_raw)
    return fetch_merkle_proof_at_idx(bucket, cfg, index, cap)


# --- tree construction helpers (for building the bucket contents) ---

def build_tree_levels(leaves: list[str], hash2: Callable[[str, str], str]
                      ) -> list[list[str]]:
    """Full tree as levels, root first. len(leaves) must be a power of 2."""
    levels = [leaves]
    cur = leaves
    while len(cur) > 1:
        cur = [hash2(cur[2 * i], cur[2 * i + 1]) for i in range(len(cur) // 2)]
        levels.append(cur)
    return levels[::-1]


def subtree_level_order(levels: list[list[str]], root_level: int,
                        root_idx: int, height: int) -> list[str]:
    """Level-order values of the height-`height` subtree rooted at
    (root_level, root_idx); index scheme matches get_subproof."""
    out = []
    for d in range(height):
        level = levels[root_level + d]
        start = root_idx << d
        out.extend(level[start : start + (1 << d)])
    return out
