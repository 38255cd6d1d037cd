"""The port's LLM examples (``examples/torch/serve_llm.py`` and
``train_llm.py``) run to their end on the CPU (``--device cpu``: the
attention kernels' plain versions), beside the JAX package's examples on
the same seeds (the port's ``init_params(cfg, 0)`` is the JAX package's
seed-0 draw bit for bit).

serve_llm: the two print the same decode counts (tokens generated,
requests completed) and the same AirTune'd page tables and modeled
costs.  train_llm: the same sample index, checkpoint manifests, restart
events and host count, and losses within 5e-3 at every printed step (the
SMOKE model trains in bfloat16, and the two frameworks round at other
places); each asserts its own "loss must decrease".
"""
import re

from test_torch_examples import finish, start


def _decode_counts(out):
    return re.search(r"(\d+) decode steps, (\d+) tokens generated, (\d+) "
                     r"requests completed", out).groups()


def test_serve_llm_equals_the_reference(tmp_path):
    port = start(["serve_llm"], tmp_path / "port")
    ref = start(["serve_llm"], tmp_path / "ref", port=False)
    got, want = finish(port), finish(ref)
    assert got.splitlines()[-1] == "OK"
    assert _decode_counts(got) == _decode_counts(want)
    tables = [ln for ln in want.splitlines() if ln.startswith("[")]
    assert len(tables) == 4
    assert tables == [ln for ln in got.splitlines() if ln.startswith("[")]


def _losses(out):
    return [float(x) for x in re.findall(r"loss=([\d.]+)", out)]


def test_train_llm_equals_the_reference(tmp_path):
    """At 30 steps (the reference's argument; the default 40 runs on the
    card in ``chip_smoke.py`` phase 18): the host dies at step 25 after
    the step-20 checkpoint either way."""
    port = start(["train_llm", "30"], tmp_path / "port")
    ref = start(["train_llm", "30"], tmp_path / "ref", port=False)
    got, want = finish(port), finish(ref)
    assert got.splitlines()[-1] == "OK"
    keep = ("[data]", "[ckpt]", "[inject]", "surviving hosts")
    assert [ln for ln in got.splitlines() if ln.startswith(keep)] == \
        [ln for ln in want.splitlines() if ln.startswith(keep)]
    ev = re.compile(r"events=(\[.*\])")
    assert ev.search(got).group(1) == ev.search(want).group(1)
    a, b = _losses(got), _losses(want)
    assert len(a) == len(b) >= 8
    assert max(abs(x - y) for x, y in zip(a, b)) < 5e-3


def test_serve_llm_keeps_the_reference_arguments(tmp_path):
    out = finish(start(["serve_llm", "6", "12"], tmp_path))
    assert out.splitlines()[-1] == "OK"
    assert _decode_counts(out)[0] == "12"
