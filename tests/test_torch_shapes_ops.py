"""The port's copies of the JAX package's ``configs/shapes.py`` and
``kernels/ops.py``: the same shapes, and the names of the reference's
public kernel wrappers bound to the port's."""
import dataclasses

from repro.configs import shapes as jshapes
from repro.kernels import ops as jops

from repro_torch.configs import shapes
from repro_torch.kernels import (decode_attention, flash_attention, moe_gmm,
                                 ops, ssd_scan)


def test_shapes_equal_the_reference():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, shape in jshapes.SHAPES.items():
        assert dataclasses.asdict(shapes.get_shape(name)) == \
            dataclasses.asdict(shape)
        assert shapes.get_shape(name).is_decode == shape.is_decode


def test_ops_exports_the_port_wrappers_under_the_reference_names():
    assert ops.__all__ == jops.__all__
    assert ops.flash_attention is flash_attention.flash_attention
    assert ops.decode_attention is decode_attention.decode_attention
    assert ops.ssd_chunk_scan is ssd_scan.ssd_chunk_scan
    assert ops.gmm is moe_gmm.gmm
    assert ops.expert_ffn is moe_gmm.expert_ffn
