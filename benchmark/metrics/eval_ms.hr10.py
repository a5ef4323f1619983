"""Host ms of one val HR@10 check of the loop, synchronized around it,
over the window's checks: ``eval_ms.rmse``'s formula."""

from benchmark import harness

read = harness.reader("eval_ms.rmse")
