"""The sequence-sharded forward of the decoder ablations on Twins_CSC
(ROADMAP A10c: ``sk_tam_v1``'s per-frame flow head, ``sk_tam_v3_noinit``'s
live temporal layer, ``use_gma=False``), through tests/_torch_seq.py's
harness: two gloo ranks on the CPU at 112x128 (decoder slabs 7/7, fnet
28/28 and cnet 28/14 stacked rows), T=4, B=1, iters 1, f32, against the
port's unsharded forward and JAX's, every leaf of JAX's variables
random.
"""

import pytest
import torch

import _torch_seq as seq

torch.set_num_threads(2)
GROUPS = ("decoders",)
RUNS = seq.runs_of(GROUPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return seq.start(GROUPS, tmp_path_factory.mktemp("seq_decoders"))


(test_seq_sharded_matches_port_unsharded, test_seq_sharded_matches_jax,
 test_seq_group_ranks_agree_bit_for_bit) = seq.parity_tests(RUNS)
test_forward_exchanges_follow_the_plan = seq.record_tests(GROUPS)
