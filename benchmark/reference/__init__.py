"""The plain reference that decides `correct`: decryption, decoding and the
expected answers, worked out from the parameters, the benchmark's secret key
and its messages.  It imports nothing of the program under test."""
