"""The generator: the same seed gives the same streams; each template's
parameters are dealt from its whole qgen space, every set once before any
repeats; rounds keep each template's share."""

from collections import Counter

import _paths

import traffic

MIXES = ["scan_agg", "joins"]
# the qgen space of each template: q1 61 DELTAs; q6 5 years x 8
# discounts x 2 quantities; q3 5 segments x 31 days; q12 7 x 6 ordered
# mode pairs x 5 years; q14 60 months
SPACE = {"q1": 61, "q6": 80, "q3": 155, "q12": 210, "q14": 60}


def mix(name, seed):
    return traffic.load_mix(_paths.BENCH / "traffic" / f"{name}.json", seed)


def test_same_seed_same_streams():
    for name in MIXES:
        a, b = mix(name, 2**31 + 11), mix(name, 2**31 + 11)
        assert [t.deck for t in a.templates] == [t.deck for t in b.templates]
        assert all(a.first(s, 200) == b.first(s, 200) for s in range(3))
        c = mix(name, 2**31 + 12)
        assert a.first(0, 50) != c.first(0, 50)


def test_decks_hold_the_whole_qgen_space():
    for name in MIXES:
        for seed in (1, 2**33 + 5):
            for tpl in mix(name, seed).templates:
                keys = {traffic.params_key(p) for p in tpl.deck}
                assert len(keys) == len(tpl.deck) == SPACE[tpl.name]
    q12 = next(t for t in mix("joins", 3).templates if t.name == "q12")
    assert all(p["SHIPMODE1"] != p["SHIPMODE2"] for p in q12.deck)
    q6 = next(t for t in mix("scan_agg", 3).templates if t.name == "q6")
    assert {p["YEAR"] for p in q6.deck} == set(range(1993, 1998))
    assert {p["QUANTITY"] for p in q6.deck} == {"24", "25"}


def test_no_parameter_set_repeats_before_the_deck_is_dealt():
    m = mix("joins", 2**31 + 99)
    sent = {t: [] for t in range(len(m.templates))}
    for s in range(m.streams):
        for t, p in m.first(s, 150):
            sent[t].append(traffic.params_key(p))
    for t, keys in sent.items():
        n = len(m.templates[t].deck)
        assert len(keys) <= n or len(set(keys)) == n
        assert len(set(keys)) == min(len(keys), n)
    setup = {traffic.params_key(m.setup_params(t, j))
             for t in range(len(m.templates)) for j in range(4)}
    window = {traffic.params_key(p) for t, p in m.first(0, 12)}
    assert not setup & window


def test_rounds_keep_the_shares():
    m = mix("joins", 7)
    assert m.streams == 3
    n = len(m.templates)
    for s in range(m.streams):
        got = [t for t, _ in m.first(s, 30 * n)]
        for r in range(30):
            assert Counter(got[r * n:(r + 1) * n]) == Counter(range(n))
    assert m.first(0, 12) != m.first(1, 12)


def test_sql_substitutes_tables_and_parameters():
    m = mix("scan_agg", 3)
    for t, p in m.first(0, 20):
        sql = m.sql(t, p, {"lineitem": "memory.default.lineitem"})
        assert "{" not in sql and "memory.default.lineitem" in sql
