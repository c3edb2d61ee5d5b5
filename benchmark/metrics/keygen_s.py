"""Host seconds to build the KeyGenerator over the secret key and derive the
cell's relin or Galois keys, ending in a synchronize: the host plane's
share of set-up."""


def read(obs):
    return obs.keygen_s
