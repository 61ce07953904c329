"""Training data pipeline with a Flash-Cosmos bitmap index.

The corpus is synthetic (deterministic hash-generated token streams, no
external data); the *selection* layer is the paper's BMI workload: every
sample carries packed metadata predicate planes (language, quality tier,
length bucket, dedup flag, ...), and batch construction ANDs the enabled
planes with one MWS reduction (the mws kernel, B1) and counts them with
the popcount kernel (B2), on the index's device.  Token streams come
from the same numpy generator as the reference's, so the batches are
identical to its.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.bitops import BitOp, pack_bits, unpack_bits
from repro_torch.core.engine import resolve_device
from repro_torch.kernels.mws import mws_reduce
from repro_torch.kernels.popcount import popcount

PREDICATES = (
    "lang_en",
    "quality_high",
    "len_ok",
    "dedup_ok",
    "license_ok",
    "not_toxic",
)


@dataclass
class BitmapIndex:
    """Packed per-sample predicate planes: (num_predicates, W) int32 words."""

    planes: torch.Tensor
    num_samples: int
    names: tuple[str, ...] = PREDICATES

    @classmethod
    def synthesize(cls, num_samples: int, seed: int = 0, density=0.8, device="cuda"):
        rng = np.random.default_rng(seed)
        bits = (rng.random((len(PREDICATES), num_samples)) < density).astype(np.uint8)
        planes = pack_bits(torch.from_numpy(bits)).to(resolve_device(device))
        return cls(planes=planes, num_samples=num_samples)

    def select(self, predicates: list[str]) -> torch.Tensor:
        """Multi-operand AND over the enabled predicate planes (the BMI
        query); returns the packed eligibility plane."""
        idx = [self.names.index(p) for p in predicates]
        return mws_reduce(self.planes[idx], BitOp.AND)

    def count(self, predicates: list[str]) -> int:
        return int(popcount(self.select(predicates)))

    def eligible_indices(self, predicates: list[str]) -> np.ndarray:
        mask = unpack_bits(self.select(predicates), self.num_samples)
        return np.nonzero(mask.cpu().numpy())[0]


@dataclass
class SyntheticCorpus:
    """Deterministic token stream per sample id (splitmix-style hashing).

    Batches are int64 token tensors on ``device``; the index lives there
    too unless one is given."""

    vocab: int
    seq_len: int
    num_samples: int = 65536
    index: BitmapIndex = field(default=None)
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.index is None:
            self.index = BitmapIndex.synthesize(self.num_samples, device=self.device)

    def sample_tokens(self, sample_id: int) -> np.ndarray:
        rng = np.random.default_rng(np.uint64(0x9E3779B9) * np.uint64(sample_id + 1))
        return rng.integers(0, self.vocab, self.seq_len + 1, dtype=np.int64)

    def batches(self, batch_size: int, predicates=("lang_en", "quality_high")):
        """Yield filtered next-token batches forever."""
        eligible = self.index.eligible_indices(list(predicates))
        if eligible.size < batch_size:
            raise ValueError(
                f"filter {predicates} keeps {eligible.size} samples, fewer than "
                f"a batch of {batch_size}"
            )
        cursor = 0
        while True:
            ids = eligible[(cursor + np.arange(batch_size)) % eligible.size]
            cursor += batch_size
            toks = torch.from_numpy(np.stack([self.sample_tokens(int(i)) for i in ids]))
            toks = toks.to(self.device)
            yield {"inputs": {"tokens": toks[:, :-1]}, "labels": toks[:, 1:]}
