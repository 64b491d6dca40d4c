"""Logger gating tests.

The reference mutes rank != 0 processes entirely (including errors
printed to the screen) via mc3.utils.Log with verb=-1
(pyratbay/tools/parser.py:612-618); errors still raise.  These tests pin
that contract for pyratbay_tpu.logger.Log, in particular that
Log.error honors verbosity/rank gating.
"""
import pytest

from pyratbay_tpu.logger import Log


def test_error_raises_and_prints_once(capsys):
    log = Log(verb=2, rank=0)
    with pytest.raises(ValueError, match='boom'):
        log.error('boom')
    captured = capsys.readouterr()
    assert captured.out == ''
    assert captured.err.count('Error: boom') == 1


def test_error_muted_at_negative_verb(capsys):
    log = Log(verb=-1, rank=0)
    with pytest.raises(ValueError, match='quiet failure'):
        log.error('quiet failure')
    captured = capsys.readouterr()
    assert captured.out == ''
    assert captured.err == ''


def test_error_muted_on_nonzero_rank(capsys):
    # rank != 0 forces verb=-1 and no log file (reference parser.py:612-618)
    log = Log(verb=2, rank=3)
    assert log.verb == -1
    with pytest.raises(ValueError):
        log.error('worker error')
    captured = capsys.readouterr()
    assert captured.out == ''
    assert captured.err == ''


def test_error_always_written_to_file(tmp_path, capsys):
    logname = str(tmp_path / 'run.log')
    log = Log(logname=logname, verb=-1, rank=0)
    with pytest.raises(ValueError):
        log.error('file only')
    assert 'Error: file only' in open(logname).read()
    assert capsys.readouterr().err == ''


def test_message_verbosity_gates(capsys):
    log = Log(verb=1, rank=0)
    log.head('visible head')
    log.msg('hidden msg')
    log.debug('hidden debug')
    out = capsys.readouterr().out
    assert 'visible head' in out
    assert 'hidden msg' not in out
    assert 'hidden debug' not in out


def test_warning_collected_and_gated(capsys):
    log = Log(verb=-1, rank=0)
    log.warning('collected but silent')
    assert log.warnings == ['collected but silent']
    captured = capsys.readouterr()
    assert captured.err == ''
