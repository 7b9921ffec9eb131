"""The sequence-sharded forward of the per-frame Twins encoders (ROADMAP
A10c: ``twins``, ``twins_1dconv``, ``twins_temporal_attention``,
``twins_3dconv``), through tests/_torch_seq.py's harness: gloo ranks on
the CPU at 232x64 (29 rows a frame, two encoder units: slabs of 28 and
1 rows, the same in every frame), T=4, B=1, iters 1, f32, against the
port's unsharded forward and JAX's, every leaf of JAX's variables random
(the hooks live):

(i)  each encoder at n_seq=2 (decoder 15/14);
(ii) ``twins_temporal_attention`` at n_seq=3 (encoder slabs 28/1/0: an
     empty one; decoder 10/10/9).
"""

import pytest
import torch

import _torch_seq as seq

torch.set_num_threads(2)
GROUPS = ("frames", "frames3")
RUNS = seq.runs_of(GROUPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return seq.start(GROUPS, tmp_path_factory.mktemp("seq_frames"))


(test_seq_sharded_matches_port_unsharded, test_seq_sharded_matches_jax,
 test_seq_group_ranks_agree_bit_for_bit) = seq.parity_tests(RUNS)
test_forward_exchanges_follow_the_plan = seq.record_tests(GROUPS)
