"""The sequence-sharded forward of StreamFlow with the UMT encoder
(ROADMAP A10e: ``encoder="umt"``, ``decoder_dim=768``, ratio 16), through
tests/_torch_seq.py's harness: one world of 6 gloo ranks on the CPU at
64x128 (a 4-row 1/16 grid, which the encoders and the decoder both
split), T=4, B=1, iters 1, f32, against the port's unsharded forward and
JAX's, every leaf of JAX's variables random. Each ViT block gathers its
keys and values whole and runs the slab's queries against them:

(i)   n_seq=2 (2/2) over make_mesh(n_data=3, n_seq=2);
(ii)  n_seq=3 (2/1/1) over make_mesh(n_data=2, n_seq=3);
(iii) n_seq=6 (1/1/1/1 and two empty slabs).
"""

import pytest
import torch

import _torch_seq as seq

torch.set_num_threads(2)
GROUPS = ("umt",)
RUNS = seq.runs_of(GROUPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return seq.start(GROUPS, tmp_path_factory.mktemp("seq_umt"))


(test_seq_sharded_matches_port_unsharded, test_seq_sharded_matches_jax,
 test_seq_group_ranks_agree_bit_for_bit) = seq.parity_tests(RUNS)
test_forward_exchanges_follow_the_plan = seq.record_tests(GROUPS)


@pytest.mark.parametrize("case,rows", [
    ("umt_2", [1, 1, 0, 0, 0, 0]), ("umt_3", [1, 1, 1, 0, 0, 0]),
    ("umt_6", [1] * 6)])
def test_data_ranks_hold_the_uneven_split(runs, case, rows):
    """B=1: data group 0 returns the clip's flows whole, the others none."""
    got = [f.shape for f, _ in seq.rank_flows(runs, "umt", case, 1)]
    assert got == [(r, 3, 64, 128, 2) for r in rows]
