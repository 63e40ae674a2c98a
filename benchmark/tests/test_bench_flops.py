"""The frozen MAC counts at both configurations: the reference's generator
counts, D's, Inception's, and the model TFLOP of one retraining
iteration."""

from __future__ import annotations

import pytest

from benchmark.lib import flops, manifest
from benchmark.reference.stylegan2 import channels, full_net_shape, uniform_student_shape


def config(size):
    """The configuration's keys the counts read: the cell's file at 256px,
    the same widths at 1024px (a configuration no cell runs yet)."""
    if size == 256:
        return manifest.config("ffhq256-11x")
    return {"size": size, "teacher_net_shape": full_net_shape(size),
            "student_net_shape": uniform_student_shape(size, 0.7),
            "discriminator_channels": {str(k): v for k, v in channels(2).items() if k <= size}}


@pytest.mark.parametrize("size, teacher, student, d, tflop", [
    (256, 45.12, 4.12, 46.53, 16.89),
    (1024, 74.27, 6.99, 76.67, 26.34),
])
def test_counts(size, teacher, student, d, tflop):
    cfg = config(size)
    assert flops.generator_macs(cfg["teacher_net_shape"]) / 1e9 == pytest.approx(teacher, abs=5e-3)
    assert flops.generator_macs(cfg["student_net_shape"]) / 1e9 == pytest.approx(student, abs=5e-3)
    channels = {int(k): v for k, v in cfg["discriminator_channels"].items()}
    assert flops.discriminator_macs(cfg["size"], channels) / 1e9 == pytest.approx(d, abs=5e-3)
    traffic = manifest.traffic("retrain-bf16-b16")
    assert 2 * flops.retrain_iteration_macs(cfg, traffic) / 1e12 == pytest.approx(tflop, abs=5e-3)


def test_reference_generator_count():
    """The reference's published totals (Util/Calculators.py:13-14)."""
    cfg = manifest.config("ffhq256-11x")
    assert flops.generator_macs(cfg["teacher_net_shape"]) == 45_124_673_536
    assert flops.generator_macs(config(1024)["teacher_net_shape"]) == 74_266_894_336


def test_inference_counts():
    assert flops.inception_macs(256) / 1e9 == pytest.approx(5.71, abs=5e-3)
    cfg = manifest.config("ffhq256-11x")
    traffic = manifest.traffic("fid-b64-chunk4096")
    assert flops.infer_image_macs(cfg, traffic) == (
        flops.generator_macs(cfg["student_net_shape"]) + flops.inception_macs(256))
    assert flops.peak_tflops("bfloat16") == 989.4 and flops.peak_tflops("float32") == 494.7
