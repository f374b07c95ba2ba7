"""`dryrun_multichip` (fissure_segmentation_tpu_torch/parallel/dryrun.py)
through its entry: two gloo ranks on the CPU run its seven steps with their
own asserts (each step holds the sharded result against the single-device
one at the tolerances the module states) and print one line a step; without
a card, the default device raises instead of falling back to the CPU."""
import pytest

from fissure_segmentation_tpu_torch.parallel import dryrun

STEPS = ("2-device DP train step ok", "10-epoch DP ModelTrainer parity ok",
         "sharded ensemble inference ok",
         "spatial halo-sharded CNN inference ok",
         "point-axis ring kNN/EdgeConv ok",
         "sharded fused-serving parity ok")


def test_dryrun_multichip_on_two_cpu_ranks(capfd):
    dryrun.dryrun_multichip(2, backend="gloo", device="cpu")
    out = capfd.readouterr().out
    for step in STEPS:
        assert f"dryrun_multichip: {step}" in out, (step, out)
    assert "3 of 3 classes' meshes equal" in out, out


@pytest.mark.parametrize("call", ["function", "cli", "nccl"])
def test_dryrun_multichip_raises_without_card(call, monkeypatch):
    monkeypatch.setattr(dryrun.torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        if call == "function":
            dryrun.dryrun_multichip(2)
        elif call == "cli":
            dryrun.main(["2"])
        else:
            dryrun.dryrun_multichip(2, backend="nccl", device="cpu")
