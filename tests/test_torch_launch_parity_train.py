"""The port's production-mesh plans of train steps held to the
reference's: ``test_torch_launch_parity.py``'s check on two train
cases, cut to a few microbatches of the shape's rows a device."""
import pytest

from test_torch_launch_parity import check_case, run_plans

CASES = {
    # the backward met local shards that disagreed with their specs:
    # jamba's train step failed on both meshes
    "jamba_train": ("jamba-v0.1-52b", "train_4k", "16x16",
                    dict(batch=32, seq=512, layers=8, microbatches=2),
                    1.5, None),
    # the attention cores' backward on the local shards, the residual
    # stream's gradient reduced as its constraint holds it
    "olmo_train": ("olmo-1b", "train_4k", "2x16x16",
                   dict(batch=64, seq=1024, microbatches=2), 1.5, None),
}


@pytest.fixture(scope="module")
def plans():
    return run_plans(CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_port_train_plan_within_bounds_of_reference(plans, case):
    """See ``test_torch_launch_parity.check_case``."""
    check_case(plans, CASES, case)
