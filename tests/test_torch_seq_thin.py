"""The sequence-sharded forward on thin and empty slabs (ROADMAP A10h),
through tests/_torch_seq.py's harness: one world of 8 gloo ranks on the
CPU at 48x64, T=4, B=1 unless named, iters 1, f32, against the port's
unsharded forward and JAX's, one case after the other:

(i)   JAX's own case (tests/test_training_infra.py:322-341): B=1 over
      make_mesh(n_data=4, n_seq=2); data groups 1-3 hold no rows;
(ii)  n_seq=8: decoder slabs 1,1,1,1,1,1,0,0 with 7-row halos read from
      up to seven ranks; one encoder unit, so seven empty encoder slabs;
(iii) B=3 over make_mesh(n_data=2, n_seq=4): decoder 2/2/1/1, data
      groups of 2 and 1 rows;
(iv)  Rows.gather and Rows.halo (2 and 5 rows) on slabs of 3, 1, 0, 2,
      1, 0, 4, 0 rows keep every bit pattern; on the same slabs, halos of
      1, 3 and 7 rows and gathers hold the whole grid's rows, and each
      rank's bytes sent and received are ``exchange.traffic``'s;
(v)   every forward's exchanges, recorded, follow the plan: no halo or
      gather through an all_reduce.
"""

import pytest
import torch

import _torch_seq as seq
import _torch_seq_worker as worker

torch.set_num_threads(2)
GROUPS = ("eight",)
RUNS = seq.runs_of(GROUPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return seq.start(GROUPS, tmp_path_factory.mktemp("seq_thin"))


(test_seq_sharded_matches_port_unsharded, test_seq_sharded_matches_jax,
 test_seq_group_ranks_agree_bit_for_bit) = seq.parity_tests(RUNS)
test_forward_exchanges_follow_the_plan = seq.record_tests(GROUPS)
(test_halos_and_gathers_match_the_whole_grid,
 test_exchange_bytes_follow_the_plan,
 test_no_exchange_goes_through_an_all_reduce) = seq.exchange_tests(
    "eight", worker.EIGHT_ROWS)


@pytest.mark.parametrize("case,rows", [
    ("jax_mesh", [1, 1, 0, 0, 0, 0, 0, 0]),
    ("empty", [1] * 8),
    ("thin", [2, 2, 2, 2, 1, 1, 1, 1])])
def test_data_ranks_hold_the_uneven_split(runs, case, rows):
    """Data rank d returns its rows of even_split(B, n_data), whole in H
    and W; a data group with none returns (0, T-1, H, W, 2)."""
    got = [f.shape for f, _ in seq.rank_flows(runs, "eight", case, 1)]
    assert got == [(r, 3, 48, 64, 2) for r in rows]


def test_mesh_places_ranks_on_the_grid(runs):
    """rank = d * n_seq + s on every mesh of the world."""
    for case, n_seq in (("jax_mesh", 2), ("empty", 8), ("thin", 4)):
        assert [r["mesh"][case] for r in runs.recs["eight"]] == [
            list(divmod(r, n_seq)) for r in range(8)]


def test_exchanges_on_thin_and_empty_slabs_keep_every_bit(runs):
    assert all(r["exchanges_exact"] for r in runs.recs["eight"])
