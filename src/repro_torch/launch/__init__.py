"""Launchers of the port: ``train`` (the run half of the JAX package's
``launch/train.py``). The dry run, the sharding specs and the serve
launcher are still to be ported."""
