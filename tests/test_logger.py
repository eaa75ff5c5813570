"""Severity logger (utils/logger.py): per-query ids, channel severity
(reference: Logger/Logger.h:95)."""

import logging

import pytest

import hdk_jax
from hdk_jax.utils import logger as hlog


def test_severity_ladder_order():
    s = hlog.SEVERITIES
    assert (s["DEBUG4"] < s["DEBUG3"] < s["DEBUG2"] < s["DEBUG1"]
            < s["INFO"] < s["WARNING"] < s["ERROR"] < s["FATAL"])


def test_unknown_severity_rejected():
    with pytest.raises(ValueError):
        hlog.configure("CHATTY")


def test_query_ids_bound_to_records(caplog):
    sess = hdk_jax.HDK(**{"debug.log_severity": "DEBUG1"})
    sess.import_pydict({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]}, name="lg")
    root = logging.getLogger("hdk_jax")
    handler_records = []

    class Capture(logging.Handler):
        def emit(self, record):
            handler_records.append(record)

    cap = Capture()
    cap.addFilter(hlog._QidFilter())
    root.addHandler(cap)
    try:
        sess.sql("SELECT k, SUM(v) AS s FROM lg GROUP BY k").to_pandas()
        sess.sql("SELECT COUNT(*) AS c FROM lg").to_pandas()
    finally:
        root.removeHandler(cap)
    qids = {r.qid for r in handler_records if r.qid != "-"}
    assert len(qids) >= 2  # two queries -> two distinct ids
    assert any(r.levelname == "DEBUG1" for r in handler_records)
    assert any("query done" in r.getMessage() for r in handler_records)


def test_default_severity_quiet(caplog):
    sess = hdk_jax.HDK()
    root = logging.getLogger("hdk_jax")
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    cap = Capture()
    root.addHandler(cap)
    try:
        sess.import_pydict({"a": [1]}, name="q")
        sess.sql("SELECT * FROM q").to_pandas()
    finally:
        root.removeHandler(cap)
    assert not [r for r in records
                if r.levelno < hlog.SEVERITIES["WARNING"]]
