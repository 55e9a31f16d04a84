"""The port's platform detection (``repro_torch.configs.platform``) against
the JAX package's: the platform and kind strings, the compiled-kernel
platforms, and detection that never routes a run (``resolve_device``
still raises where there is no card)."""
import pytest
import torch

from repro.configs import platform as jplatform
from repro_torch.configs import platform as tplatform


def test_detect_platform_names_the_host():
    assert tplatform.detect_platform("cpu") == "cpu"
    assert tplatform.detect_platform(torch.device("cpu")) == "cpu"
    # the JAX package on its CPU device gives the same word
    assert jplatform.detect_platform() == "cpu"


def test_detect_platform_names_a_cuda_device_gpu():
    # detection only reads the device's type: no card is touched
    assert tplatform.detect_platform("cuda") == "gpu"
    assert tplatform.detect_platform(torch.device("cuda", 1)) == "gpu"
    assert tplatform.detect_platform("meta") == "meta"


def test_compiled_kernel_platforms():
    assert tplatform.compiled_kernel_platforms() == ("gpu",)
    assert set(tplatform.compiled_kernel_platforms()) < set(
        jplatform.compiled_kernel_platforms())
    assert tplatform.supports_compiled_kernels("gpu")
    assert not tplatform.supports_compiled_kernels("cpu")
    assert not tplatform.supports_compiled_kernels("tpu")
    assert jplatform.supports_compiled_kernels("gpu")
    assert not jplatform.supports_compiled_kernels("cpu")


def test_no_card_is_detected_as_cpu_and_still_refused(monkeypatch):
    """Without a card detection reads "cpu", as the JAX package reads a
    failed device init; the entry points' device resolution still raises
    instead of falling back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tplatform.detect_platform() == "cpu"
    assert tplatform.detect_device_kind() == "cpu"
    assert not tplatform.supports_compiled_kernels()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplatform.resolve_device()
    assert tplatform.resolve_device("cpu") == torch.device("cpu")


def test_card_is_detected_as_gpu_with_its_name(monkeypatch):
    """With a card, None means the card, and its kind is the name
    ``torch.cuda.get_device_name`` gives (the string roofline matches)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tplatform.detect_platform() == "gpu"
    assert tplatform.supports_compiled_kernels()
    assert tplatform.detect_device_kind() == "NVIDIA H100 80GB HBM3"
    assert tplatform.detect_device_kind("cuda:0") == "NVIDIA H100 80GB HBM3"
    assert tplatform.detect_device_kind("cpu") == "cpu"
    assert tplatform.resolve_device() == torch.device("cuda")


def test_detect_device_kind_on_the_host_matches_jax():
    assert tplatform.detect_device_kind("cpu") == "cpu"
    assert jplatform.detect_device_kind() == "cpu"


def test_jax_only_names_are_not_ported():
    """set_platform, set_cpu_devices and GPU_XLA_FLAGS pin JAX's backend
    and XLA flags; the port has no counterpart (CHANGES.md)."""
    from repro_torch import configs

    for name in ("set_platform", "set_cpu_devices", "GPU_XLA_FLAGS"):
        assert hasattr(jplatform, name)
        assert not hasattr(tplatform, name)
        assert not hasattr(configs, name)
    for name in ("detect_platform", "detect_device_kind",
                 "compiled_kernel_platforms", "supports_compiled_kernels",
                 "resolve_device"):
        assert name in configs.__all__
