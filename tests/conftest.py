import pathlib
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# ---------------------------------------------------------------------------
# hypothesis gate: the container doesn't ship hypothesis and nothing may be
# pip-installed, so provide a minimal deterministic stand-in with the same
# surface the tests use (@given + st.integers/sampled_from, @settings).
# Property tests then run as seeded example sweeps instead of shrinking
# searches — strictly weaker, but the properties still execute.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import random
    import types

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _integers(min_value=0, max_value=1 << 30):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def _sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda rng: rng.choice(seq))

    def _floats(min_value=0.0, max_value=1.0, **_):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def _booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    def _lists(elem, min_size=0, max_size=None):
        hi = max_size if max_size is not None else min_size + 10
        return _Strategy(lambda rng: [elem.draw(rng) for _ in
                                      range(rng.randint(min_size, hi))])

    def _settings(max_examples=10, deadline=None, **_):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    def _given(*pos_strategies, **kw_strategies):
        def deco(fn):
            # no functools.wraps: pytest must not follow __wrapped__ and
            # mistake the drawn parameters for fixtures.
            def wrapper():
                rng = random.Random(0)
                for _ in range(getattr(wrapper, "_max_examples", 10)):
                    args = [s.draw(rng) for s in pos_strategies]
                    kwargs = {k: s.draw(rng)
                              for k, s in kw_strategies.items()}
                    fn(*args, **kwargs)
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__dict__.update(fn.__dict__)
            return wrapper
        return deco

    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = _integers
    st_mod.sampled_from = _sampled_from
    st_mod.floats = _floats
    st_mod.booleans = _booleans
    st_mod.lists = _lists

    hyp = types.ModuleType("hypothesis")
    hyp.given = _given
    hyp.settings = _settings
    hyp.strategies = st_mod
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st_mod


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one "
        "(run on the card: python -m pytest -m cuda tests/test_torch_cuda.py)")
