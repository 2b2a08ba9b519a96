"""End to end on the CPU: the port's engine and CLI against the JAX package's
numpy backend (and, for one case, its Pallas backend in interpret mode).
Winner tuples and output bytes must be equal."""

import numpy as np
import pytest

from psa_tpu.core.alphabet import OTHER_CODE
from psa_tpu.models.search import AlignmentSearchEngine as JaxEngine
from psa_tpu.utils import cli as jax_cli

from psa_torch.core.result import NoMutationFound
from psa_torch.models.search import AlignmentSearchEngine
from psa_torch.utils import cli
from psa_torch.utils.generator import random_sequences, write_input_file

from conftest import random_codes, random_seq

WEIGHT_SETS = [
    (1.0, 3.0, 4.0, 2.0),   # golden weights
    (5.0, 1.0, 1.0, 1.0),   # ties between dot/space diffs
    (2.0, 2.0, 2.0, 2.0),   # everything ties
    (1.5, 0.25, 3.75, 0.5), # exact binary fractions
    (-1.0, 2.0, -3.0, 4.0), # negative weights (legal per fscanf %lf)
    (0.0, 0.0, 0.0, 0.0),   # every total ties
]


def winner(res):
    return (res.offset, res.char_offset, res.sub_code, res.score)


@pytest.mark.parametrize("weights", WEIGHT_SETS)
@pytest.mark.parametrize("is_max", [True, False])
def test_winner_matches_jax_numpy(weights, is_max):
    rng = np.random.default_rng(hash((weights, is_max)) % 2**32)
    for n1, n2 in [(700, 150), (1500, 1024), (64, 64), (2100, 33)]:
        c1 = random_codes(rng, n1)
        c2 = random_codes(rng, n2)
        want = JaxEngine(weights, is_max, backend="numpy").search_codes(c1, c2)
        got = AlignmentSearchEngine(weights, is_max, device="cpu").search_codes(c1, c2)
        assert winner(got) == winner(want), (n1, n2)
        host = AlignmentSearchEngine(weights, is_max, backend="numpy").search_codes(c1, c2)
        assert winner(host) == winner(want), (n1, n2)


def test_lenient_no_mutation_matches_jax():
    """Out-of-range chars everywhere: every pair weighs 0 with no legal
    substitution, the defined no-mutation path of both packages."""
    c1 = np.full(300, OTHER_CODE, np.int32)
    c2 = np.full(40, OTHER_CODE, np.int32)
    for eng in (AlignmentSearchEngine((1, 3, 4, 2), True, device="cpu",
                                      strict_alphabet=False),
                AlignmentSearchEngine((1, 3, 4, 2), True, backend="numpy",
                                      strict_alphabet=False)):
        with pytest.raises(NoMutationFound):
            eng.search_codes(c1, c2)
    from psa_tpu.core.result import NoMutationFound as JaxNoMutation

    with pytest.raises(JaxNoMutation):
        JaxEngine((1, 3, 4, 2), True, backend="numpy").search_codes(c1, c2)


def test_strict_alphabet_rejects_like_jax():
    with pytest.raises(ValueError):
        AlignmentSearchEngine((1, 3, 4, 2), False, device="cpu").search("AB?C", "A")
    with pytest.raises(ValueError):
        JaxEngine((1, 3, 4, 2), False, backend="numpy").search("AB?C", "A")


def test_one_case_matches_jax_pallas_interpret():
    rng = np.random.default_rng(9)
    s1, s2 = random_seq(rng, 700), random_seq(rng, 150)
    want = JaxEngine((1, 3, 4, 2), False, backend="pallas").search(s1, s2)
    got = AlignmentSearchEngine((1, 3, 4, 2), False, device="cpu").search(s1, s2)
    assert winner(got) == winner(want)


CLI_CASES = [
    ((1.0, 3.0, 4.0, 2.0), False, 3000, 400, 0.0, []),
    ((2.0, 1.0, 5.0, 0.5), True, 1200, 1200, 0.05, []),
    ((1.0, 3.0, 4.0, 2.0), True, 800, 90, 0.0, ["--explain"]),
    ((1.0, 3.0, 4.0, 2.0), False, 500, 60, 0.0, ["--print-table", "--json"]),
]


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


@pytest.mark.parametrize("case", range(len(CLI_CASES)))
def test_cli_bytes_match_jax(case, tmp_path, capsys):
    weights, is_max, n1, n2, hp, extra = CLI_CASES[case]
    s1, s2 = random_sequences(n1, n2, seed=case, hyphen_p=hp)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), weights, s1, s2, is_max)
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    rc_a, out_a = _run(cli.main, [str(inp), "-o", str(a), "--device", "cpu",
                                  "--quiet", *extra], capsys)
    rc_b, out_b = _run(jax_cli.main, [str(inp), "-o", str(b), "--backend",
                                      "numpy", "--quiet", *extra], capsys)
    assert rc_a == rc_b == 0
    assert a.read_bytes() == b.read_bytes()
    if "--explain" in extra:
        # psa_tpu's pretty_print binds sys.stdout when first imported, so its
        # output may miss capsys: hold the port's against its render instead
        from psa_tpu.utils.io import read_input
        from psa_tpu.utils.pretty import render

        q = read_input(str(inp))
        r = JaxEngine(q.weights, q.is_max, backend="numpy").search(q.seq1, q.seq2)
        assert out_a == render(q, r, color=False) + "\n"
        return
    if "--json" in extra:
        import json

        ja, jb = json.loads(out_a.splitlines()[-1]), json.loads(out_b.splitlines()[-1])
        ja.pop("time_s"), jb.pop("time_s")
        assert ja == jb
        out_a, out_b = out_a.rsplit("\n", 2)[0], out_b.rsplit("\n", 2)[0]
    assert out_a == out_b


def test_cli_no_mutation_and_case_match_jax(tmp_path, capsys):
    inp = tmp_path / "in.txt"
    inp.write_text("1 3 4 2 ??????? ??? maximum\n1 3 4 2 ABCDEFGH CDE minimum\n")
    for extra in (["--lenient"], ["--case", "1"]):
        a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
        rc_a, _ = _run(cli.main, [str(inp), "-o", str(a), "--device", "cpu",
                                  "--quiet", *extra], capsys)
        rc_b, _ = _run(jax_cli.main, [str(inp), "-o", str(b), "--backend",
                                      "numpy", "--quiet", *extra], capsys)
        assert rc_a == rc_b
        assert a.read_bytes() == b.read_bytes()
    for argv in ([str(tmp_path / "missing.txt")], [str(inp), "--case", "5"],
                 [str(inp)]):                       # strict alphabet: rc 2
        assert (cli.main([*argv, "--device", "cpu", "--quiet", "-o",
                          str(tmp_path / "x.txt")])
                == jax_cli.main([*argv, "--backend", "numpy", "--quiet", "-o",
                                 str(tmp_path / "y.txt")]) == 2)


@pytest.mark.parametrize("color", [False, True])
def test_render_matches_jax(color):
    from psa_tpu.utils.io import parse_input as jax_parse
    from psa_tpu.utils.pretty import render as jax_render
    from psa_tpu.utils.pretty import render_sign_table as jax_table

    from psa_torch.utils.io import parse_input
    from psa_torch.utils.pretty import render, render_sign_table

    s1, s2 = random_sequences(400, 70, seed=3, hyphen_p=0.05)
    text = f"1 3 4 2 {s1} {s2} minimum"
    q, jq = parse_input(text), jax_parse(text)
    res = AlignmentSearchEngine(q.weights, q.is_max, device="cpu").search(q.seq1, q.seq2)
    jres = JaxEngine(jq.weights, jq.is_max, backend="numpy").search(jq.seq1, jq.seq2)
    assert render(q, res, color=color) == jax_render(jq, jres, color=color)
    assert render_sign_table() == jax_table()
