// A kernel source for G009's twin (never compiled).
extern "C" int crdt_good(const int* a, int* b, int n, void* stream) {
  return 0;
}

extern "C" int crdt_wide(const int* a, int n, uint64_t epoch,
                         void* stream) {
  return 0;
}

extern "C" int crdt_short(const int* a, int* b, int n, void* stream) {
  return 0;
}

extern "C" int crdt_kind(const int* a, int* b, int n, void* stream) {
  return 0;
}

extern "C" int crdt_norow(int n) { return 0; }

extern "C" const char* crdt_error_string(int err) { return ""; }
