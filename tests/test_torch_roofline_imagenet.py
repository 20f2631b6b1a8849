"""The port's ``model_layer_table`` against the JAX package's for every
ImageNet arch both registries share (the CIFAR archs, and the rest of the
roofline, in ``test_torch_roofline.py``): row by row and exactly, at batch
1 and 8, in f32 and bf16, and with ``twoblock``; ``static_table`` on the
flagship's rows against the H100 SXM5 ceilings."""

import pytest

from test_torch_roofline import check_layer_table, layer_table_cases


@pytest.mark.parametrize("dataset,arch,batch,dtype,twoblock", layer_table_cases("imagenet"))
def test_model_layer_table_is_the_references(dataset, arch, batch, dtype, twoblock):
    check_layer_table(dataset, arch, batch, dtype, twoblock)
