"""The port's production-mesh plans of train steps held to the
reference's: ``test_torch_launch_parity.py``'s check on two train
cases, cut to a few microbatches of the shape's rows a device."""
import pytest

from test_torch_launch_parity import check_case, run_plans

WHISPER_PIN = 0.891   # whisper_train's ratio at its cut

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
    # the router's gradient reached it with the tokens strided over
    # "model": DTensor reran its backward on gathered inputs (an
    # aten.bmm fallback, 16x the work); and the checkpointed block's
    # recompute ran the MoE combine, which XLA's remat leaves out
    "deepseek_train": ("deepseek-moe-16b", "train_4k", "2x16x16",
                       dict(batch=64, seq=1024, layers=2, microbatches=2),
                       (1.0, 1.02), None),
    "dbrx_train": ("dbrx-132b", "train_4k", "2x16x16",
                   dict(batch=64, seq=1024, layers=1, microbatches=2),
                   (1.0, 1.02), None),
    # pinned below the reference, not repaired: XLA computes the
    # decoder's 16 heads' scores and the tied unembedding's input
    # gradient whole on every device, the port shards both; copying
    # XLA's redundant work would make the real sharded step slower. The
    # ratio this cut reads (WHISPER_PIN), +-2%
    "whisper_train": ("whisper-medium", "train_4k", "2x16x16",
                      dict(batch=64, seq=1024, microbatches=2),
                      (0.98 * WHISPER_PIN, 1.02 * WHISPER_PIN), None),
}


# the one fallback left, pinned so that a change shows: at this cut the
# backward of jamba's SSD output reshape (``models/ssm.py``'s
# ``yc.transpose(0, 1).reshape``) meets a gradient DTensor cannot view
FALLBACKS = {"jamba_train": {"aten.view.default": "batch kept"}}


@pytest.fixture(scope="module")
def plans():
    return run_plans(CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_port_train_plan_within_bounds_of_reference(plans, case):
    """See ``test_torch_launch_parity.check_case``."""
    check_case(plans, CASES, case, FALLBACKS.get(case))
