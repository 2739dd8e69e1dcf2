"""The int8 moments under the tensor plan against the data plan, on 2 x 2
gloo ranks (ROADMAP C17).

The tiny dense model trains 5 steps with int8 moments under (data 2,
tensor 2), where the moments of a leaf whose last axis is split over
``model`` are quantized a piece of whole rows at a time
(``optim/adamw.py``), and under the data plan, where every rank holds
every moment whole.  After each step the two plans' stored moments are
compared leaf by leaf: while their gradients agree to fp32 rounding, no
int8 payload of a split leaf may differ by more than one quantization
step, and its scales agree to the same rounding.  Once the gradients part
(the int8 moments store a small ``nu`` as 0, and a step can then jump by
``lr · mu_hat / eps``: ROADMAP C10), the plans are no longer comparable
and the test stops comparing.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import run_ranks  # noqa: E402

STEPS = 5
#: gradients agree to fp32 rounding: each leaf within this share of its
#: largest magnitude
GRAD_RTOL = 1e-4


def _agree(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.abs(a - b).max() <= GRAD_RTOL * max(np.abs(b).max(), 1e-30))


def test_split_row_int8_moments_match_the_data_plan(tmp_path):
    np.savez(tmp_path / "inputs.npz", steps=STEPS)
    ranks = run_ranks("int8_plans", 4, tmp_path, timeout=240.0)
    r = ranks[0]
    split = r["split"]
    assert split.any(), "no leaf has its last axis split under the tensor plan"
    n_leaves = len(split)
    compared = 0
    for i in range(STEPS):
        grads = [(r[f"tensor/{i}/g{j}"], r[f"data/{i}/g{j}"]) for j in range(n_leaves)]
        if not all(_agree(a, b) for a, b in grads):
            break
        compared += 1
        # the moment leaves: mu then nu, each leaf's payload then scales
        for m in range(2):
            for j in range(n_leaves):
                if not split[j]:
                    continue
                k = 2 * (m * n_leaves + j)
                q_t, q_d = r[f"tensor/{i}/z{k}"], r[f"data/{i}/z{k}"]
                s_t, s_d = r[f"tensor/{i}/z{k + 1}"], r[f"data/{i}/z{k + 1}"]
                steps_apart = np.abs(q_t.astype(np.int32) - q_d.astype(np.int32))
                assert steps_apart.max() <= 1, (
                    f"step {i + 1}, {'mu' if m == 0 else 'nu'} of leaf {j}: a row differs by "
                    f"{steps_apart.max()} quantization steps while the gradients agree")
                np.testing.assert_allclose(s_t, s_d, rtol=GRAD_RTOL, atol=0)
    assert compared >= 2, f"the plans' gradients part at step {compared + 1}"
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["tensor/grad_norms"], r["tensor/grad_norms"])
