"""The port's twin of ``test_rapp_learns_better_than_random`` of
``tests/test_rapp.py`` (a file of its own: the suite runs one file a
worker, and this run is the longest of the RaPP tests)."""
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.rapp import dataset as D, train as T

CPU = "cpu"


def test_rapp_learns_better_than_random():
    """Tiny training run: MAPE must drop well below the untrained level."""
    corpus = [ARCHS["olmo-1b"], ARCHS["qwen2.5-3b"]]
    ds = D.generate(corpus, batches=(1, 8), samples_per_graph=10, seed=1)
    tr, va, te = D.split(ds, holdout_archs=())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite runs in several processes
    try:
        params = T.train(tr, va, cfg=T.TrainConfig(steps=200,
                                                   log_every=1000),
                         verbose=False, device=CPU)
    finally:
        torch.set_num_threads(threads)
    mape = T.evaluate(params, tr)
    assert mape < 40.0, f"train MAPE {mape}"
