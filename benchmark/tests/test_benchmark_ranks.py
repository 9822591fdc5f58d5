"""The launch of a cell's ranks: rank 0's last line passed on, nothing
where a rank fails."""

import textwrap

from benchmark.core.ranks import launch

SCRIPT = textwrap.dedent("""
    import os, sys
    rank = int(os.environ["RANK"])
    assert os.environ["WORLD_SIZE"] == "3" and os.environ["MASTER_ADDR"] == "127.0.0.1"
    assert float(os.environ["CLIBD_BENCH_T_START"]) == 123.5
    print(f"rank {rank} says", file=sys.stderr)
    if sys.argv[1] == "fail" and rank == 2:
        sys.exit(7)
    print("noise")
    print('{"rank": %d}' % rank)
""")


def test_rank_zero_line_is_passed_on(tmp_path, capsys):
    script = tmp_path / "ranked.py"
    script.write_text(SCRIPT)
    assert launch(str(script), ["ok"], 3, 123.5, lambda: []) == 0
    out, err = capsys.readouterr()
    assert out.strip().splitlines() == ['{"rank": 0}']
    assert "rank 0 says" in err and "rank 1 says" not in err


def test_a_failed_rank_prints_no_result(tmp_path, capsys):
    script = tmp_path / "ranked.py"
    script.write_text(SCRIPT)
    assert launch(str(script), ["fail"], 3, 123.5, lambda: []) != 0
    out, err = capsys.readouterr()
    assert out == "" and "rank 2 exit 7" in err


def test_jax_in_the_printing_process_prints_no_result(tmp_path, capsys):
    script = tmp_path / "ranked.py"
    script.write_text(SCRIPT)
    assert launch(str(script), ["ok"], 3, 123.5, lambda: ["jax"]) != 0
    assert capsys.readouterr().out == ""
