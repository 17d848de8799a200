"""chip_smoke.py on the CPU: the device phase refuses a machine without a
GPU, ``--four`` selects only its phase, and every parity and e2e phase
function runs end to end at tiny widths (the full widths run on the card).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from vidgraph_tpu.models.captioner import CaptionerConfig  # noqa: E402
from vidgraph_tpu.models.vit import ViTConfig  # noqa: E402


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.device_phase(1)


def test_main_fails_at_device_on_cpu(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    out = capsys.readouterr().out
    assert '"ok"' not in out          # no result line without a GPU


@pytest.mark.parametrize("argv, want", [
    (["--four"], ["device:4", "four"]),
    ([], ["device:1", "parity_topk", "parity_vit", "parity_captioner",
          "parity_wdot", "parity_attention", "parity_acs", "e2e"]),
])
def test_phase_selection(monkeypatch, capsys, argv, want):
    calls = []

    def dev(count):
        calls.append(f"device:{count}")
        return {"platform": "gpu", "kind": "fake", "count": count}

    monkeypatch.setattr(chip_smoke, "device_phase", dev)
    for name in ("four_phase", "parity_topk", "parity_vit",
                 "parity_captioner", "parity_wdot", "parity_attention",
                 "parity_acs"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: calls.append(
                                _n.replace("_phase", "")))
    monkeypatch.setattr(chip_smoke, "e2e_phase",
                        lambda *a, **k: calls.append("e2e"))
    assert chip_smoke.main(argv) == 0
    assert calls == want
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    f'"fake", "count": {4 if argv else 1}}}}}')


def test_parity_phases_tiny(monkeypatch):
    # XLA:CPU converts int8 dots; whether XLA:GPU keeps them is checked
    # on the card
    monkeypatch.setattr(chip_smoke, "_int8_dot_kept", lambda hlo: True)
    chip_smoke.parity_topk(0, rows=8200, dim=32, queries=4)
    chip_smoke.parity_vit(0, frames=4, height=48, width=64,
                          vit_cfg=ViTConfig.tiny())
    chip_smoke.parity_captioner(0, cap_cfg=CaptionerConfig.tiny(), rows=2,
                                tokens=8, steps=4)
    chip_smoke.parity_wdot(0, shapes=[(8, 256, 384)])
    chip_smoke.parity_attention(0, cases=((2, 40),), cfg=CaptionerConfig(
        width=32, layers=1, heads=2, num_vision_tokens=4),
        grad_case=(2, 24))
    chip_smoke.parity_acs(0, nodes=120)


def _tiny_sizes():
    chat = CaptionerConfig(width=32, layers=2, heads=2, vision_dim=32,
                           num_vision_tokens=2, max_len=640,
                           dtype=jnp.float32)
    return chip_smoke.Sizes(
        vit=ViTConfig.tiny(), captioner=CaptionerConfig.tiny(), chat=chat,
        caption_max_new=8, chat_max_new=16, kg_chat_max_new=32, streams=2,
        height=48, width=64, fps=10.0, frames_per_chunk=2, warm_seconds=1.0,
        video_seconds=2.0, live_queries=2, history_rows=8200, kg_captions=6,
        retrieval_queries=2, http_ingests=4, http_queries=2)


def test_e2e_phase_tiny():
    chip_smoke.e2e_phase(_tiny_sizes(), seed=0)


def test_four_phase_tiny_on_virtual_devices():
    """The --four phase on four of the conftest's virtual CPU devices."""
    chip_smoke.four_phase(0, rows=9000, dim=32, cap_cfg=CaptionerConfig(
        width=64, layers=2, heads=4, vision_dim=32, num_vision_tokens=2,
        max_len=96), steps=4)


@pytest.mark.parametrize("line, kept", [
    ("%d = s32[8,384]{1,0} dot(s8[8,256]{1,0} %a, s8[256,384]{1,0} %b)",
     True),
    ('%g = (s32[8,384]{1,0}, s8[0]{0}) custom-call(s8[8,256]{1,0} %a, '
     's8[256,384]{1,0} %b), custom_call_target="__cublas$gemm"', True),
    ("%gemm_fusion_dot_general.1_computation (parameter_0: s8[8,4,512], "
     "parameter_1: s8[512,6144,4]) -> s32[4,6144,8] {", True),
    ("%c = f32[256,384]{1,0} convert(s8[256,384]{1,0} %b)", False),
    ("%d = f32[8,384]{1,0} dot(f32[8,256]{1,0} %a, f32[256,384]{1,0} %c)",
     False),
])
def test_int8_dot_detector(line, kept):
    assert chip_smoke._int8_dot_kept("HloModule m\n" + line) is kept


def test_camera_frames_vary():
    a = chip_smoke.camera(0, 48, 64)
    b = chip_smoke.camera(1, 48, 64)
    f0, f1, g0 = next(a), next(a), next(b)
    assert f0.shape == (48, 64, 3) and f0.dtype.name == "uint8"
    assert (f0 != f1).any() and (f0 != g0).any()


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke on the card, in a child process that may open it."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith('{"ok": true')
