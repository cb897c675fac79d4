"""The drivers of the traffic mixes' programs, one file a program."""
