"""``examples_torch/quickstart.py`` against the reference's
``examples/quickstart.py`` on the CPU.

The reference's normal draws (``jax.random.normal`` in sections 2 and 4)
are replaced by the port's seeded draws, so both scripts work on the same
numpy arrays; its ``PRNGKey`` integer draws (section 1) the port redraws
bit for bit (``core/prng.py``).  Every printed line must then be the
reference's, character for character, apart from section 2's title, which
names the port's route: sections 1 and 3, section 2's errors,
quantization errors and bytes, section 4's hit rate, section 5's table
and the Fig. 12 staircase."""
import jax
import jax.numpy as jnp

from _torch_examples import (load, one_torch_thread,  # noqa: F401
                             printed, refuses_missing_cuda, run_reference)

SECTION2_TITLE = 7       # the line of section 2's title in both outputs


def test_quickstart_prints_the_reference_lines(monkeypatch):
    port = load("examples_torch", "quickstart")
    draws = {tuple(t.shape): t.numpy() for t in port.draws().values()}
    assert len(draws) == 3
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(draws[tuple(shape)]))
    want = run_reference(load("examples", "quickstart"), [], monkeypatch)
    errs, got = printed(port.main, ["--device", "cpu"])
    assert len(got) == len(want) == 25
    assert want[SECTION2_TITLE].startswith("2. TPU kernel")
    assert got[SECTION2_TITLE].startswith("2. LUT-dequant matmul")
    for i, (g, w) in enumerate(zip(got, want)):
        if i != SECTION2_TITLE:
            assert g == w, (i, g, w)
    assert errs == {2: 0.0, 4: 0.0, 8: 0.0}
    text = "\n".join(got)
    assert "CPU-only" not in text and "Pallas" not in text


def test_quickstart_refuses_a_missing_cuda_device(monkeypatch):
    refuses_missing_cuda(load("examples_torch", "quickstart"), monkeypatch)
