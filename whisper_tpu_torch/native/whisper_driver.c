/* Minimal C driver over the port's C-ABI engine binding
 * (whisper_engine_capi.cpp beside it): create, transcribe one file, print
 * the transcript, destroy. The port's copy of native/whisper_driver.c.
 *
 * Usage: whisper_driver <config_json> <wav_path>
 * e.g.   whisper_driver '{"model":"tiny","language":"en","device":"cuda",
 *                         "max_new_tokens":8,"pythonpath":"REPO:SITE"}' \
 *        utt.wav
 */

#include <stdio.h>
#include <stdlib.h>

void* wh_engine_create(const char* config_json);
char* wh_engine_transcribe_file(void* handle, const char* path);
void wh_engine_destroy(void* handle);
const char* wh_engine_error(void);
void wh_engine_string_free(char* s);

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: %s <config_json> <wav_path>\n", argv[0]);
    return 2;
  }
  void* engine = wh_engine_create(argv[1]);
  if (engine == NULL) {
    fprintf(stderr, "create failed: %s\n", wh_engine_error());
    return 1;
  }
  char* text = wh_engine_transcribe_file(engine, argv[2]);
  if (text == NULL) {
    fprintf(stderr, "transcribe failed: %s\n", wh_engine_error());
    wh_engine_destroy(engine);
    return 1;
  }
  printf("%s\n", text);
  wh_engine_string_free(text);
  wh_engine_destroy(engine);
  return 0;
}
