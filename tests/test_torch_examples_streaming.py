"""The port's ``corpus_pattern_mining`` and ``streaming_bigdata`` examples
against the JAX package's: on the CPU, in this process, the same printed
lines with times and launch counts masked (``tests/_torch_examples.py``).
``streaming_bigdata`` runs at 6,000 rows (its default is 20,000): six
chunks of 1,024 rows, still killed mid level 2 and resumed.  The other
five are in ``test_torch_examples.py``."""
import pytest

from _torch_examples import assert_same_output, run_main


@pytest.mark.parametrize("name,args", [
    ("corpus_pattern_mining", ()),
    ("streaming_bigdata", ("--rows", "6000")),
    ("streaming_bigdata", ("--rows", "6000", "--backend", "auto")),
])
def test_example_prints_what_the_jax_example_prints(name, args):
    jax_out = run_main(name, port=False, args=args)
    torch_out = run_main(name, port=True, args=args)
    assert_same_output(name, jax_out, torch_out)
    if name == "streaming_bigdata":
        assert "killed at level" in torch_out
        assert "identical to uninterrupted run" in torch_out
