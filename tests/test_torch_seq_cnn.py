"""The sequence-sharded forward of the CNN encoders (ROADMAP A10d:
``basic``, one module with ``resnet18`` and ``mf_basic``, and
``res18_3d``), through tests/_torch_seq.py's harness: gloo ranks on the
CPU at 48x64 (a 6-row 1/8 grid, split as the decoder's; the input's
slabs 8 times those rows, so each stride-2 conv's output slab is its
input slab's half), T=4, iters 1, f32, against the port's unsharded
forward and JAX's, every leaf of JAX's variables random (Res18_3D's hooks
live, the fnet's InstanceNorm on every conv):

(i)   n_seq=2 (3/3), B=1 over make_mesh(n_data=4, n_seq=2);
(ii)  n_seq=4 (2/2/1/1: 8-row input slabs, 2-row slabs after layer3's
      stride), over make_mesh(n_data=2, n_seq=4);
(iii) n_seq=8 (six of 1, two empty: the empty ranks join every halo and
      every InstanceNorm sum);
(iv)  B=3 over make_mesh(n_data=2, n_seq=2) (a world of 4);
(v)   each conv kind of the RAFT CNN (the stem's 7x7/s2/p3, 3x3/s1/p1,
      3x3/s2/p1, the 1x1/s2 downsample) and InstanceNorm on slabs of
      6, 2, 0, 2, 4, 0, 34, 0 rows against the whole layer's rows.
"""

import pytest
import torch

import _torch_seq as seq
import _torch_seq_worker as worker

torch.set_num_threads(2)
GROUPS = ("cnn", "cnn_grid")
RUNS = seq.runs_of(GROUPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return seq.start(GROUPS, tmp_path_factory.mktemp("seq_cnn"))


(test_seq_sharded_matches_port_unsharded, test_seq_sharded_matches_jax,
 test_seq_group_ranks_agree_bit_for_bit) = seq.parity_tests(RUNS)
test_forward_exchanges_follow_the_plan = seq.record_tests(GROUPS)


@pytest.mark.parametrize("layer", [*worker.SLAB_CONVS, "instance_norm"])
def test_layers_on_thin_and_empty_slabs_equal_the_whole_layer(runs, layer):
    """Every rank's output rows of the layer on its slab: the whole
    layer's rows, of the same shape (none for an empty slab), within f32
    rounding (the slab's conv runs at another shape; InstanceNorm's sums
    add in another order)."""
    for r, rec in enumerate(runs.recs["cnn"]):
        same_shape, err = rec["slab_layers"][layer]
        assert same_shape, (layer, r)
        assert err <= 2e-5, (layer, r, err)
